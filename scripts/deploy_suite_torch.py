#!/usr/bin/env python3
"""The deploy step of the port (DeployAccountFactory.s.sol:47-88 parity).

    python3 scripts/deploy_suite_torch.py [--verifier-code FILE --proof FILE]

Deploys the chain suite into the port's in-repo EVM (evm/machine.Chain):
the SNARK verifier, EntryPoint, the account implementation, the factory,
SponsorPaymaster (and its deposit) and Counter; creates an account, sends
one UserOperation through `handleOps`, checks that the counter reads 1, and
prints a forge-style gas report (contracts/README.md:6-30 parity). The
contracts are chain/contracts.py's, compiled by evm/yulc.py; the calls are
encoded by chain/abi.py.

Verifier:
  --verifier-code FILE   deploy bytecode as JSON, {"code": [...]} (the .code
                         file api.generate_verifier writes), with --proof, a
                         hex file whose bytes are the UserOperation's
                         signature
  (default)              a stub that accepts any non-empty calldata whose
                         length is a multiple of 32 (the ERC-4337 overhead
                         apart from the SNARK verification's gas)

A failed deploy, a failed call or a reverted handleOps exits nonzero and
prints what failed with the revert data. Runs on the host: no card needed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from webauthn_halo2_tpu_torch.chain import abi, contracts  # noqa: E402
from webauthn_halo2_tpu_torch.chain.abi import UserOperation, selector  # noqa: E402
from webauthn_halo2_tpu_torch.evm.machine import Chain  # noqa: E402
from webauthn_halo2_tpu_torch.evm.yulc import compile_contract  # noqa: E402

ETH = 10**18
DEPLOYER = 0xD3B10  # the broadcast EOA
BENEFICIARY = 0xFEE

# stub verifier: success iff calldatasize() > 0 and calldatasize() % 32 == 0
STUB_VERIFIER_YUL = """
if iszero(calldatasize()) { revert(0, 0) }
if mod(calldatasize(), 32) { revert(0, 0) }
return(0, 0)
"""


def _succeeded(what: str, res):
    """`res`, or SystemExit (exit 1) naming `what` with its revert data."""
    if not res.success:
        raise SystemExit(f"{what} failed (gas {res.gas_used:,}): revert data "
                         f"0x{res.output.hex()}")
    return res


def run(verifier_code: bytes | None = None, proof: bytes | None = None) -> list:
    """Deploy the suite and send one UserOperation; returns the gas report,
    (name, gas) in the order the JAX script prints them. Raises
    SystemExit on the first deploy or call that fails."""
    chain = Chain()
    chain.set_balance(DEPLOYER, 10_000 * ETH)
    report: list[tuple[str, int]] = []

    def deploy(name: str, code: bytes) -> int:
        addr, res = chain.create(DEPLOYER, code)
        report.append((f"deploy {name}", _succeeded(f"deploy {name}", res).gas_used))
        return addr

    def call(what: str, to: int, data: bytes, value: int = 0):
        return _succeeded(what, chain.call(DEPLOYER, to, data, value=value))

    if verifier_code is not None:
        verifier = deploy("Verifier (generated)", verifier_code)
    else:
        proof = bytes(64)  # any 32-aligned payload satisfies the stub
        verifier = deploy("Verifier (stub)", compile_contract(STUB_VERIFIER_YUL)[0])

    ep = deploy("EntryPoint", contracts.compile_entry_point()[0])
    impl = deploy("P256Account impl", contracts.compile_account_impl()[0])
    factory = deploy("P256AccountFactory", contracts.compile_factory(impl, ep, verifier)[0])
    paymaster = deploy("SponsorPaymaster", contracts.compile_paymaster(ep, DEPLOYER)[0])
    counter = deploy("Counter", contracts.compile_counter()[0])

    # the paymaster's deposit (the script sends 1 ETH: DeployAccountFactory.s.sol)
    res = call("paymaster.deposit", paymaster, selector("deposit()").to_bytes(4, "big"),
               value=1 * ETH)
    report.append(("paymaster.deposit(1 ETH)", res.gas_used))

    res = call("factory.createAccount", factory,
               abi.encode_create_account(b"deploy-script-demo-key"))
    account = int.from_bytes(res.output, "big")
    report.append(("factory.createAccount", res.gas_used))

    # the account's EntryPoint deposit, then one UserOperation end to end
    call("EntryPoint.depositTo", ep, selector("depositTo(address)").to_bytes(4, "big")
         + account.to_bytes(32, "big"), value=10 * ETH)
    op = UserOperation(
        sender=account,
        call_data=abi.encode_execute(counter, 0, selector("increment()").to_bytes(4, "big")),
        signature=proof,
    )
    res = call("handleOps", ep, abi.encode_handle_ops([op], BENEFICIARY))
    report.append(("handleOps (1 op, e2e)", res.gas_used))

    res = call("Counter.number", counter, selector("number()").to_bytes(4, "big"))
    number = int.from_bytes(res.output, "big")
    if number != 1:
        raise SystemExit(f"the counter reads {number} after handleOps, not 1")
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--verifier-code", help="deploy bytecode JSON artifact")
    ap.add_argument("--proof", help="hex proof file (the userOp signature)")
    args = ap.parse_args(argv)
    if (args.verifier_code is None) != (args.proof is None):
        ap.error("--verifier-code and --proof go together")
    code = proof = None
    if args.verifier_code:
        with open(args.verifier_code) as f:
            code = bytes(json.load(f)["code"])
        with open(args.proof) as f:
            proof = bytes.fromhex(f.read().strip().removeprefix("0x"))
    report = run(code, proof)
    print("== gas report (in-repo EVM; reference tables at "
          "contracts/README.md:6-30) ==")
    for name, gas in report:
        print(f"  {name:32s} {gas:>12,}")
    print("counter incremented through handleOps: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
