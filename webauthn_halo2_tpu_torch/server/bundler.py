"""Bundler-lite: the web demo's on-chain leg, served in-process.

The port's counterpart of the JAX package's server/bundler.py, with the
same flow and receipts. The reference demo submits its proof-as-signature
UserOperation to a Pimlico bundler over JSON-RPC and polls for a receipt
(index.tsx:296-429: counterfactual sender via the getSenderAddress
revert-parse trick, initCode when undeployed, eth_sendUserOperation,
eth_getUserOperationReceipt). This module runs that flow against the
port's in-repo stack: the generated production verifier, EntryPoint-lite,
factory, paymaster and Counter run as real bytecode in evm/machine.py,
and the three HTTP routes of server/app.py (/chain/sender,
/chain/submit_userop, /chain/receipt) play the bundler.

State is an in-memory singleton chain, deployed lazily on first use from
the verifier that evm/codegen.py generates for the production circuit's
key, which `api.proving_key` builds on the card (or on `device`). One
lock orders the requests that reach the chain.
"""
from __future__ import annotations

import threading

from ..chain import abi, contracts
from ..chain.abi import UserOperation, selector
from ..evm.machine import Chain
from ..evm.yul_asm import compile_yul

RICHARD = 0x1234  # funder/beneficiary (the demo's EOA stand-in)
ETH = 10 ** 18

_LOCK = threading.Lock()
_WORLD: "World | None" = None


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


class World:
    def __init__(self, params=None, verifier_deploy: bytes | None = None,
                 device=None):
        if verifier_deploy is None:
            from .. import api
            from ..evm.codegen import generate_verifier as _gen

            params = params or api.CircuitParams(degree=17)
            pk = api.proving_key(params, device=device)
            num_public = params.num_limbs if params.expose_msghash else 0
            yul, _sol = _gen(pk.vk, pk.srs, num_public=num_public)
            deploy, _runtime = compile_yul(yul)
        else:
            deploy = verifier_deploy  # tests inject a verifier of their own
        self._lock = threading.Lock()
        self.chain = Chain()
        self.chain.set_balance(RICHARD, 10_000 * ETH)
        vaddr, res = self.chain.create(RICHARD, deploy)
        _require(res.success, "verifier deployment failed")
        self.suite = contracts.deploy_suite(self.chain, RICHARD, vaddr)
        caddr, res = self.chain.create(
            RICHARD, contracts.compile_counter()[0])
        _require(res.success, "Counter deployment failed")
        self.suite["counter"] = caddr
        # sponsor gas through the paymaster (the demo's Pimlico analog)
        res = self.chain.call(
            RICHARD, self.suite["entry_point"],
            selector("depositTo(address)").to_bytes(4, "big")
            + self.suite["paymaster"].to_bytes(32, "big"),
            value=100 * ETH)
        _require(res.success, "the paymaster's deposit failed")
        self.receipts: dict[str, dict] = {}

    # -- the getSenderAddress revert-parse trick (index.tsx:327-341) ------
    def sender_for(self, public_key: bytes) -> int:
        with self._lock:
            return self._sender_for(public_key)

    def _sender_for(self, public_key: bytes) -> int:
        init_code = abi.init_code_for(self.suite["factory"], public_key)
        data = (selector("getSenderAddress(bytes)").to_bytes(4, "big")
                + (0x20).to_bytes(32, "big")
                + abi.encode_bytes(init_code))
        res = self.chain.call(RICHARD, self.suite["entry_point"], data)
        _require(not res.success, "getSenderAddress must revert")
        _require(int.from_bytes(res.output[:4], "big")
                 == contracts.SENDER_ADDRESS_RESULT_SELECTOR,
                 "getSenderAddress reverted without SenderAddressResult")
        return int.from_bytes(res.output[4:36], "big")

    def counter_value(self) -> int:
        res = self.chain.call(RICHARD, self.suite["counter"],
                              selector("number()").to_bytes(4, "big"))
        return int.from_bytes(res.output[-32:], "big") if res.success else -1

    def submit(self, public_key: bytes, proof: bytes) -> dict:
        """Assemble and execute the demo's UserOperation: increment the
        Counter from the passkey's (counterfactual) account, proof as
        signature, paymaster sponsoring (index.tsx:380-414)."""
        with self._lock:
            return self._submit(public_key, proof)

    def _submit(self, public_key: bytes, proof: bytes) -> dict:
        sender = self._sender_for(public_key)
        undeployed = len(self.chain.account(sender).code) == 0
        init_code = (abi.init_code_for(self.suite["factory"], public_key)
                     if undeployed else b"")
        nonce_res = self.chain.call(
            RICHARD, self.suite["entry_point"],
            selector("getNonce(address,uint192)").to_bytes(4, "big")
            + sender.to_bytes(32, "big") + (0).to_bytes(32, "big"))
        nonce = int.from_bytes(nonce_res.output[:32], "big")
        op = UserOperation(
            sender=sender,
            nonce=nonce & 0xFFFFFFFFFFFFFFFF,
            init_code=init_code,
            call_data=abi.encode_execute(
                self.suite["counter"], 0,
                selector("increment()").to_bytes(4, "big")),
            call_gas_limit=10_000_000,
            verification_gas_limit=10_000_000,
            pre_verification_gas=1_000_000,
            max_fee_per_gas=10_000_000,          # 900k-gas demo constants
            max_priority_fee_per_gas=10_000_000,  # (index.tsx:380-382)
            paymaster_and_data=self.suite["paymaster"].to_bytes(20, "big"),
            signature=proof,
        )
        op_hash = "0x" + op.hash(self.suite["entry_point"],
                                 self.chain.chain_id).hex()
        before = self.counter_value()
        res = self.chain.call(RICHARD, self.suite["entry_point"],
                              abi.encode_handle_ops([op], RICHARD))
        after = self.counter_value()
        receipt = {
            "userOpHash": op_hash,
            "success": bool(res.success),
            "gasUsed": res.gas_used,
            "sender": f"0x{sender:040x}",
            "accountDeployed": bool(undeployed and res.success),
            "counterBefore": before,
            "counterAfter": after,
            "revertData": "" if res.success else res.output.hex(),
        }
        self.receipts[op_hash] = receipt
        return receipt

    def receipt(self, op_hash: str) -> dict | None:
        with self._lock:
            return self.receipts.get(op_hash)


def world(params=None, device=None) -> World:
    """The server's chain, deployed on first use (None: keys on the card)."""
    global _WORLD
    with _LOCK:
        if _WORLD is None:
            _WORLD = World(params, device=device)
        return _WORLD
