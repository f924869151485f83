"""The port's on-chain layer against the JAX package's (CPU, no keygen).

The ERC-4337 contracts (chain/contracts.py), their Yul compiler
(evm/yulc.py) and the ABI helpers (chain/abi.py) are copies, so their
bytes must equal the JAX package's. The ERC-4337 scenarios of
tests/test_chain_e2e.py then run on the port's EVM with the production
k=17 verifier (the port's compile_yul of results/P256Verifier.yul) and
the JAX package's k=17 GWC proof (results/proof_gwc_k17.hex) as the
UserOperation's signature, and the port's bundler World gives the JAX
World's receipts field for field: gas is deterministic. Each call of the
production verifier takes about half a second on this CPU.
"""
import functools
import pathlib

import pytest

from webauthn_halo2_tpu.chain import abi as jabi
from webauthn_halo2_tpu.chain import contracts as jcontracts
from webauthn_halo2_tpu.evm import yulc as jyulc
from webauthn_halo2_tpu_torch.chain import abi, contracts
from webauthn_halo2_tpu_torch.chain.abi import UserOperation, selector
from webauthn_halo2_tpu_torch.evm import yulc
from webauthn_halo2_tpu_torch.evm.machine import Chain
from webauthn_halo2_tpu_torch.evm.yul_asm import compile_yul

ROOT = pathlib.Path(__file__).resolve().parent.parent
RICHARD = 0x1234  # the funder (t.sol's makeAddr("richard"))
BENEFICIARY = 0xBEEF
PUBLIC_KEY = b"iliketturtles"  # P256Account.t.sol's registration constant
ETH = 10**18

# each compile_* with fixed constructor addresses
COMPILERS = {
    "entry_point": lambda m: m.compile_entry_point(),
    "account_impl": lambda m: m.compile_account_impl(),
    "factory": lambda m: m.compile_factory(0x1001, 0x1002, 0x1003),
    "paymaster": lambda m: m.compile_paymaster(0x1002, RICHARD),
    "mock_aggregator": lambda m: m.compile_mock_aggregator(),
    "counter": lambda m: m.compile_counter(),
}
SOURCES = ("ENTRY_POINT_YUL", "P256_ACCOUNT_YUL", "P256_ACCOUNT_FACTORY_YUL",
           "SPONSOR_PAYMASTER_YUL", "COUNTER_YUL", "MOCK_AGGREGATOR_YUL")


@pytest.mark.parametrize("name", sorted(COMPILERS))
def test_contract_bytecode_matches_jax(name):
    deploy, runtime = COMPILERS[name](contracts)
    assert (deploy, runtime) == COMPILERS[name](jcontracts)
    assert runtime and deploy.endswith(runtime)


@pytest.mark.parametrize("source", SOURCES)
def test_yulc_matches_jax_on_each_source(source):
    src = getattr(contracts, source)
    assert src == getattr(jcontracts, source)
    if "{IMPL}" in src or "{ENTRY_POINT}" in src:
        src = contracts._template(src, IMPL=0x1001, ENTRY_POINT=0x1002,
                                  VERIFIER=0x1003, OWNER=RICHARD)
    assert yulc.compile_contract(src) == jyulc.compile_contract(src)
    assert yulc.compile_runtime(src, 0x5000) == jyulc.compile_runtime(src, 0x5000)


def test_contract_constants_match_jax():
    for name in ("USER_OPERATION_EVENT_TOPIC", "FAILED_OP_SELECTOR",
                 "SENDER_ADDRESS_RESULT_SELECTOR", "VALIDATION_RESULT_SELECTOR",
                 "VALIDATE_SIGNATURES_SELECTOR", "AGGREGATOR_MAGIC"):
        assert getattr(contracts, name) == getattr(jcontracts, name), name


def _ops(m):
    """Two UserOperations with every field set, from module m's class."""
    return [m.UserOperation(sender=0xA11CE, nonce=7, init_code=b"\x01" * 45,
                            call_data=b"\x02" * 70, call_gas_limit=123,
                            verification_gas_limit=456, pre_verification_gas=789,
                            max_fee_per_gas=1011, max_priority_fee_per_gas=1213,
                            paymaster_and_data=b"\x03" * 20, signature=b"\x04" * 97),
            m.UserOperation(sender=0xB0B, signature=b"")]


def test_abi_encodings_match_jax():
    for sig in ("handleOps", "increment()", "getNonce(address,uint192)"):
        assert abi.selector(sig) == jabi.selector(sig)
    ops, jops = _ops(abi), _ops(jabi)
    for op, jop in zip(ops, jops):
        assert op.encode_struct() == jop.encode_struct()
        assert op.pack_for_hash() == jop.pack_for_hash()
        assert op.hash(0xE1, 31337) == jop.hash(0xE1, 31337)
    assert abi.encode_bytes(b"\x05" * 33) == jabi.encode_bytes(b"\x05" * 33)
    assert abi.encode_handle_ops(ops, BENEFICIARY) == jabi.encode_handle_ops(jops, BENEFICIARY)
    assert abi.encode_ops_array(ops) == jabi.encode_ops_array(jops)
    groups = [(ops, 0xA66, b"\x06" * 32), (ops[:1], 0, b"")]
    jgroups = [(jops, 0xA66, b"\x06" * 32), (jops[:1], 0, b"")]
    assert (abi.encode_handle_aggregated_ops(groups, BENEFICIARY)
            == jabi.encode_handle_aggregated_ops(jgroups, BENEFICIARY))
    assert abi.encode_simulate_validation(ops[0]) == jabi.encode_simulate_validation(jops[0])
    assert abi.encode_execute(0xC0, 5, b"\x07" * 4) == jabi.encode_execute(0xC0, 5, b"\x07" * 4)
    assert abi.encode_create_account(PUBLIC_KEY) == jabi.encode_create_account(PUBLIC_KEY)
    assert abi.encode_get_address(PUBLIC_KEY) == jabi.encode_get_address(PUBLIC_KEY)
    assert abi.init_code_for(0xFAC, PUBLIC_KEY) == jabi.init_code_for(0xFAC, PUBLIC_KEY)


@functools.lru_cache(maxsize=None)
def production_verifier() -> tuple[bytes, bytes]:
    """(deploy bytecode of results/P256Verifier.yul by the port's
    assembler, the JAX package's k=17 GWC proof)."""
    deploy, _runtime = compile_yul((ROOT / "results" / "P256Verifier.yul").read_text())
    proof = bytes.fromhex((ROOT / "results" / "proof_gwc_k17.hex").read_text().strip())
    return deploy, proof


@pytest.fixture()
def world():
    """A fresh chain with the suite, the production verifier and a Counter."""
    deploy, proof = production_verifier()
    chain = Chain()
    chain.set_balance(RICHARD, 1000 * ETH)
    vaddr, res = chain.create(RICHARD, deploy)
    assert res.success, "verifier deployment failed"
    suite = contracts.deploy_suite(chain, RICHARD, vaddr)
    caddr, res = chain.create(RICHARD, contracts.compile_counter()[0])
    assert res.success
    suite["counter"] = caddr
    return chain, suite, proof


def _call(chain, sender, to, data, value=0):
    return chain.call(sender, to, data, value=value)


def _word(res, i=0) -> int:
    return int.from_bytes(res.output[32 * i:32 * (i + 1)], "big")


def _create_account(chain, suite) -> int:
    res = _call(chain, RICHARD, suite["factory"], abi.encode_create_account(PUBLIC_KEY))
    assert res.success, "createAccount failed"
    return _word(res)


def _fund_deposit(chain, suite, account: int, wei: int) -> None:
    res = _call(chain, RICHARD, suite["entry_point"],
                selector("depositTo(address)").to_bytes(4, "big")
                + account.to_bytes(32, "big"), value=wei)
    assert res.success


def _user_op(chain, suite, account: int, signature: bytes, paymaster: int = 0,
             init_code: bytes = b"") -> UserOperation:
    nonce_res = _call(chain, RICHARD, suite["entry_point"],
                      selector("getNonce(address,uint192)").to_bytes(4, "big")
                      + account.to_bytes(32, "big") + (0).to_bytes(32, "big"))
    call_data = abi.encode_execute(suite["counter"], 0,
                                   selector("increment()").to_bytes(4, "big"))
    pmd = paymaster.to_bytes(20, "big") if paymaster else b""
    return UserOperation(
        sender=account, nonce=_word(nonce_res), init_code=init_code,
        call_data=call_data, paymaster_and_data=pmd, signature=signature,
        call_gas_limit=10_000_000, verification_gas_limit=10_000_000,
        pre_verification_gas=1_000_000, max_fee_per_gas=10_000_000,
        max_priority_fee_per_gas=10_000_000,
    )


def _handle_ops(chain, suite, ops):
    return _call(chain, RICHARD, suite["entry_point"], abi.encode_handle_ops(ops, BENEFICIARY))


def _counter_value(chain, suite) -> int:
    return _word(_call(chain, RICHARD, suite["counter"], selector("number()").to_bytes(4, "big")))


def test_account_creation(world):
    """Deterministic address, stored publicKey, idempotent createAccount."""
    chain, suite, _ = world
    pred = _word(_call(chain, RICHARD, suite["factory"], abi.encode_get_address(PUBLIC_KEY)))
    account = _create_account(chain, suite)
    assert account == pred
    assert chain.account(account).code
    res = _call(chain, RICHARD, account, selector("publicKey()").to_bytes(4, "big"))
    assert res.success
    assert res.output[64:64 + _word(res, 1)] == PUBLIC_KEY
    assert _create_account(chain, suite) == account
    assert _word(_call(chain, RICHARD, account,
                       selector("entryPoint()").to_bytes(4, "big"))) == suite["entry_point"]
    assert _word(_call(chain, RICHARD, account,
                       selector("snarkVerifier()").to_bytes(4, "big"))) == suite["verifier"]


def test_user_op_e2e_success(world):
    """The production proof as signature: the counter increments through
    handleOps, the beneficiary is paid, one UserOperationEvent with
    success = 1."""
    chain, suite, proof = world
    account = _create_account(chain, suite)
    _fund_deposit(chain, suite, account, 10 * ETH)
    res = _handle_ops(chain, suite, [_user_op(chain, suite, account, proof)])
    assert res.success, res.output.hex()[:100]
    assert _counter_value(chain, suite) == 1
    assert chain.account(BENEFICIARY).balance > 0
    ev = [lg for lg in res.logs
          if lg.topics and lg.topics[0] == contracts.USER_OPERATION_EVENT_TOPIC]
    assert len(ev) == 1
    assert int.from_bytes(ev[0].data[32:64], "big") == 1


@pytest.mark.parametrize("bad", ["empty", "truncated", "zeroed"])
def test_user_op_e2e_failure(world, bad):
    """A bad signature: FailedOp AA24 revert, counter unchanged."""
    chain, suite, proof = world
    sig = {"empty": b"", "truncated": proof[:-32], "zeroed": bytes(len(proof))}[bad]
    account = _create_account(chain, suite)
    _fund_deposit(chain, suite, account, 10 * ETH)
    res = _handle_ops(chain, suite, [_user_op(chain, suite, account, sig)])
    assert not res.success
    assert res.output[:4] == contracts.FAILED_OP_SELECTOR.to_bytes(4, "big")
    assert b"AA24" in res.output, res.output.hex()
    assert _counter_value(chain, suite) == 0


def test_user_op_with_paymaster(world):
    """The paymaster pays: the account needs no deposit, the paymaster's
    deposit is charged."""
    chain, suite, proof = world
    account = _create_account(chain, suite)
    res = _call(chain, RICHARD, suite["paymaster"], selector("deposit()").to_bytes(4, "big"),
                value=20 * ETH)
    assert res.success
    bal = selector("balanceOf(address)").to_bytes(4, "big") + suite["paymaster"].to_bytes(32, "big")
    before = _word(_call(chain, RICHARD, suite["entry_point"], bal))
    assert before == 20 * ETH
    res = _handle_ops(chain, suite, [_user_op(chain, suite, account, proof,
                                              paymaster=suite["paymaster"])])
    assert res.success, res.output.hex()[:100]
    assert _counter_value(chain, suite) == 1
    assert _word(_call(chain, RICHARD, suite["entry_point"], bal)) < before


def test_user_op_with_paymaster_no_deposit(world):
    chain, suite, proof = world
    account = _create_account(chain, suite)
    res = _handle_ops(chain, suite, [_user_op(chain, suite, account, proof,
                                              paymaster=suite["paymaster"])])
    assert not res.success
    assert b"AA31" in res.output, res.output.hex()


def test_init_code_counterfactual_deployment(world):
    """getSenderAddress reverts with SenderAddressResult; a userOp with
    initCode deploys the account and executes in one handleOps."""
    chain, suite, proof = world
    pred = _word(_call(chain, RICHARD, suite["factory"], abi.encode_get_address(PUBLIC_KEY)))
    assert not chain.account(pred).code
    init_code = abi.init_code_for(suite["factory"], PUBLIC_KEY)
    res = _call(chain, RICHARD, suite["entry_point"],
                selector("getSenderAddress(bytes)").to_bytes(4, "big")
                + (0x20).to_bytes(32, "big") + abi.encode_bytes(init_code))
    assert not res.success
    assert res.output[:4] == contracts.SENDER_ADDRESS_RESULT_SELECTOR.to_bytes(4, "big")
    assert int.from_bytes(res.output[4:36], "big") == pred
    _fund_deposit(chain, suite, pred, 10 * ETH)
    res = _handle_ops(chain, suite, [_user_op(chain, suite, pred, proof, init_code=init_code)])
    assert res.success, res.output.hex()[:100]
    assert chain.account(pred).code
    assert _counter_value(chain, suite) == 1


def test_entrypoint_gated_setters_and_inherit(world):
    chain, suite, _ = world
    account = _create_account(chain, suite)
    ep = suite["entry_point"]
    heir = 0x4321
    set_inh = selector("setInheritor(address)").to_bytes(4, "big") + heir.to_bytes(32, "big")
    assert not _call(chain, RICHARD, account, set_inh).success
    assert _call(chain, ep, account, set_inh).success
    limit = selector("setInactiveTimeLimit(uint256)").to_bytes(4, "big") + (0).to_bytes(32, "big")
    assert _call(chain, ep, account, limit).success
    chain.set_balance(account, 5 * ETH)
    chain.timestamp += 1_000_000
    res = _call(chain, heir, account, selector("inherit()").to_bytes(4, "big"))
    assert res.success, res.output.hex()
    assert chain.account(heir).balance == 5 * ETH
    assert not _call(chain, 0x9999, account, selector("inherit()").to_bytes(4, "big")).success


def test_stake_manager_lifecycle(world):
    chain, suite, _ = world
    ep = suite["entry_point"]

    def add_stake(delay):
        return selector("addStake(uint32)").to_bytes(4, "big") + delay.to_bytes(32, "big")

    info_call = selector("getDepositInfo(address)").to_bytes(4, "big") + RICHARD.to_bytes(32, "big")
    assert not _call(chain, RICHARD, ep, add_stake(0), value=ETH).success
    assert _call(chain, RICHARD, ep, add_stake(100), value=2 * ETH).success
    assert not _call(chain, RICHARD, ep, add_stake(50)).success
    info = _call(chain, RICHARD, ep, info_call)
    assert info.success
    assert (_word(info, 1), _word(info, 2), _word(info, 3)) == (1, 2 * ETH, 100)
    wd = selector("withdrawStake(address)").to_bytes(4, "big") + (0x7777).to_bytes(32, "big")
    unlock = selector("unlockStake()").to_bytes(4, "big")
    assert not _call(chain, RICHARD, ep, wd).success
    assert _call(chain, RICHARD, ep, unlock).success
    assert not _call(chain, RICHARD, ep, unlock).success
    assert not _call(chain, RICHARD, ep, wd).success
    chain.timestamp += 101
    assert _call(chain, RICHARD, ep, wd).success
    assert chain.account(0x7777).balance == 2 * ETH
    assert _word(_call(chain, RICHARD, ep, info_call), 2) == 0


@pytest.mark.parametrize("valid", [True, False], ids=["proof", "zeroed"])
def test_simulate_validation(world, valid):
    """simulateValidation always reverts with ValidationResult: sigFailed
    0 for the production proof, 1 for a zeroed one; the prefund."""
    chain, suite, proof = world
    account = _create_account(chain, suite)
    _fund_deposit(chain, suite, account, 10 * ETH)
    op = _user_op(chain, suite, account, proof if valid else bytes(len(proof)))
    res = _call(chain, RICHARD, suite["entry_point"], abi.encode_simulate_validation(op))
    assert not res.success
    assert int.from_bytes(res.output[:4], "big") == contracts.VALIDATION_RESULT_SELECTOR
    body = res.output[4:]
    ri_off = int.from_bytes(body[0:32], "big")
    assert ri_off == 0xE0
    assert int.from_bytes(body[ri_off + 64:ri_off + 96], "big") == (0 if valid else 1)
    assert int.from_bytes(body[ri_off + 32:ri_off + 64], "big") == op.max_fee_per_gas * (
        op.call_gas_limit + op.verification_gas_limit + op.pre_verification_gas)


def test_handle_aggregated_ops(world):
    """handleAggregatedOps: the aggregator's validateSignatures runs per
    group; a bad aggregated signature fails the bundle with AA96; a group
    with aggregator 0 behaves like handleOps."""
    chain, suite, proof = world
    agg, res = chain.create(RICHARD, contracts.compile_mock_aggregator()[0])
    assert res.success
    account = _create_account(chain, suite)
    _fund_deposit(chain, suite, account, 10 * ETH)
    magic = contracts.AGGREGATOR_MAGIC.to_bytes(32, "big")

    def bundle(aggregator, sig):
        ops = [_user_op(chain, suite, account, proof)]
        return _call(chain, RICHARD, suite["entry_point"],
                     abi.encode_handle_aggregated_ops([(ops, aggregator, sig)], BENEFICIARY))

    res = bundle(agg, magic)
    assert res.success, res.output.hex()[:100]
    assert _counter_value(chain, suite) == 1
    assert _word(_call(chain, RICHARD, agg, selector("number()").to_bytes(4, "big"))) == 1
    res = bundle(agg, b"\x00" * 32)
    assert not res.success
    assert b"AA96" in res.output, res.output.hex()
    assert _counter_value(chain, suite) == 1
    assert bundle(0, b"").success
    assert _counter_value(chain, suite) == 2


def test_world_receipts_match_jax():
    """The port's bundler World and the JAX World on the same verifier,
    public key and proofs: equal receipts, field for field."""
    from webauthn_halo2_tpu.server.bundler import World as JaxWorld
    from webauthn_halo2_tpu_torch.server.bundler import World

    deploy, proof = production_verifier()
    port, jax_world = World(verifier_deploy=deploy), JaxWorld(verifier_deploy=deploy)
    pub = bytes(range(64))
    assert port.sender_for(pub) == jax_world.sender_for(pub) != 0
    receipts = []
    for sig in (proof, proof, bytes(len(proof))):
        got = port.submit(pub, sig)
        assert got == jax_world.submit(pub, sig)
        assert port.receipt(got["userOpHash"]) == got
        receipts.append(got)
    assert [r["gasUsed"] for r in receipts[:2]] == [1_105_292, 853_489]
    assert [(r["success"], r["accountDeployed"], r["counterBefore"], r["counterAfter"])
            for r in receipts] == [(True, True, 0, 1), (True, False, 1, 2), (False, False, 2, 2)]
    assert port.counter_value() == 2
