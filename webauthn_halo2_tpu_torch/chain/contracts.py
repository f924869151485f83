"""The on-chain layer (SURVEY L6): ERC-4337 contract suite in structured Yul.

The port's copy of the JAX package's chain/contracts.py, compiled by the
port's evm/yulc.py: the same sources, so the same bytecode.

Equivalents of the reference's Solidity contracts
(contracts/src/ — P256Account.sol, P256AccountFactory.sol,
SponsorPaymaster.sol, vendored eth-infinitism core/EntryPoint.sol),
written from scratch in the framework's own Yul dialect and compiled to
real deployable bytecode by evm/yulc.py (no solc exists in this
environment; the reference builds these with forge).

Behavioral parity notes (file:line cites into the reference's sources):
* EntryPoint: v0.6-style handleOps — per-op: sender deployment via
  initCode factory call, nonce (key<<64|seq) validation,
  account.validateUserOp with missingAccountFunds, optional paymaster
  validation + deposit charge, execution with callGasLimit, deposit
  refund, UserOperationEvent, beneficiary compensation
  (core/EntryPoint.sol:92,228; StakeManager deposits; NonceManager).
  simulateValidation (always-revert ValidationResult) and the
  aggregator path (handleAggregatedOps + IAggregator.validateSignatures,
  core/EntryPoint.sol:228, interfaces/IAggregator.sol) are implemented
  in the same lite style.
* P256Account: initialize(entryPoint, publicKey, snarkVerifier) once;
  setters gated to the entrypoint; inherit() dead-man switch transfers
  the balance after inactivity (P256Account.sol:32-71);
  _validateSignature = `snarkVerifier.call(userOp.signature)`, 1 on
  failure (P256Account.sol:74-83) — the proof IS the signature, with the
  same zero-public-input binding gap the reference documents.
* P256AccountFactory: CREATE2 with salt = keccak(publicKey), proxy to a
  shared implementation, createAccount idempotently returns the address,
  getAddress computes the counterfactual (P256AccountFactory.sol:32-73).
  We use an EIP-1167 minimal proxy instead of OZ's ERC1967Proxy — same
  architecture (shared implementation + per-account proxy storage),
  ~10x smaller init code.
* SponsorPaymaster: pays for everything; whitelist kept but not enforced
  in validation, matching the reference's commented-out check
  (SponsorPaymaster.sol:28-33); owner-managed authorized map; deposit
  forwarding to the EntryPoint.

Constructor arguments are baked by templating the sources (the same
convention the verifier codegen uses for vk constants).
"""
from __future__ import annotations

from ..utils.keccak import keccak256
from .abi import selector

# full event topic for UserOperationEvent (v0.6 signature)
USER_OPERATION_EVENT_TOPIC = int.from_bytes(keccak256(
    b"UserOperationEvent(bytes32,address,address,uint256,bool,uint256,uint256)"
), "big")

# error selectors (4-byte, v0.6 EntryPoint errors)
FAILED_OP_SELECTOR = selector("FailedOp(uint256,string)")
SENDER_ADDRESS_RESULT_SELECTOR = selector("SenderAddressResult(address)")
VALIDATION_RESULT_SELECTOR = selector(
    "ValidationResult((uint256,uint256,bool,uint48,uint48,bytes),"
    "(uint256,uint256),(uint256,uint256),(uint256,uint256))")
# IAggregator.validateSignatures (interfaces/IAggregator.sol:1-36)
VALIDATE_SIGNATURES_SELECTOR = selector(
    "validateSignatures((address,uint256,bytes,bytes,uint256,uint256,"
    "uint256,uint256,uint256,bytes,bytes)[],bytes)")


def _fail(i_expr: str, msg: str) -> str:
    """Emit a `revert FailedOp(opIndex, reason)` Yul call with the string
    length computed here (the dialect's string literal is a left-aligned
    32-byte word)."""
    assert len(msg) <= 32
    return f'failOp({i_expr}, "{msg}", {len(msg)})'


# ---------------------------------------------------------------------------
# EntryPoint
# ---------------------------------------------------------------------------
# memory map: 0x000-0x0FF mapping-slot scratch; 0x100-0x3FF struct-hash
# scratch; locals at 0x4000 (compiler default); 0x10000+ big buffers for
# variable-length copies / sub-call calldata.

ENTRY_POINT_YUL = f"""
// EntryPoint (ERC-4337 v0.6-lite). Deposits + nonces + handleOps.

function depositSlot(a) -> s {{
    mstore(0x00, a)
    mstore(0x20, 0)
    s := keccak256(0x00, 0x40)
}}
function nonceSlot(a, key) -> s {{
    mstore(0x00, a)
    mstore(0x20, key)
    mstore(0x40, 1)
    s := keccak256(0x00, 0x60)
}}
// StakeManager storage (core/StakeManager.sol parity): per-address stake
// amount (domain 2) + packed info (domain 3):
//   bit 255 = staked, bits [48,80) = unstakeDelaySec,
//   bits [0,48) = withdrawTime
function stakeSlot(a) -> s {{
    mstore(0x00, a)
    mstore(0x20, 2)
    s := keccak256(0x00, 0x40)
}}
function stakeInfoSlot(a) -> s {{
    mstore(0x00, a)
    mstore(0x20, 3)
    s := keccak256(0x00, 0x40)
}}
function ceil32(x) -> y {{ y := and(add(x, 31), not(31)) }}
function failOp(i, reason, rlen) {{
    mstore(0x00, shl(224, 0x{FAILED_OP_SELECTOR:08x}))
    mstore(0x04, i)
    mstore(0x24, 0x40)
    mstore(0x44, rlen)
    mstore(0x64, reason)
    revert(0x00, 0x84)
}}
function hashBytesAt(op, headOff) -> h {{
    let ptr := add(op, calldataload(add(op, headOff)))
    let len := calldataload(ptr)
    calldatacopy(0x10000, add(ptr, 32), len)
    h := keccak256(0x10000, len)
}}
function userOpHash(op) -> h {{
    // inner: keccak(abi.encode(sender, nonce, kec(initCode), kec(callData),
    //   cgl, vgl, pvg, maxFee, maxPrio, kec(paymasterAndData)))
    mstore(0x140, hashBytesAt(op, 64))
    mstore(0x160, hashBytesAt(op, 96))
    mstore(0x220, hashBytesAt(op, 288))
    mstore(0x100, calldataload(op))
    mstore(0x120, calldataload(add(op, 32)))
    mstore(0x180, calldataload(add(op, 128)))
    mstore(0x1a0, calldataload(add(op, 160)))
    mstore(0x1c0, calldataload(add(op, 192)))
    mstore(0x1e0, calldataload(add(op, 224)))
    mstore(0x200, calldataload(add(op, 256)))
    let inner := keccak256(0x100, 0x140)
    // outer: keccak(abi.encode(inner, address(this), chainid))
    mstore(0x100, inner)
    mstore(0x120, address())
    mstore(0x140, chainid())
    h := keccak256(0x100, 0x60)
}}
function opLen(op) -> l {{
    // struct byte length: signature is the last dynamic tail
    let sigOff := calldataload(add(op, 320))
    l := add(add(sigOff, 32), ceil32(calldataload(add(op, sigOff))))
}}
function paymasterOf(op) -> pm {{
    let ptr := add(op, calldataload(add(op, 288)))
    if iszero(lt(calldataload(ptr), 20)) {{
        pm := shr(96, calldataload(add(ptr, 32)))
    }}
}}
function createSender(i, op) {{
    let initPtr := add(op, calldataload(add(op, 64)))
    let initLen := calldataload(initPtr)
    if lt(initLen, 20) {{ {_fail("i", "AA20 account not deployed")} }}
    let factory := shr(96, calldataload(add(initPtr, 32)))
    calldatacopy(0x10000, add(initPtr, 52), sub(initLen, 20))
    let ok := call(gas(), factory, 0, 0x10000, sub(initLen, 20), 0x00, 0x20)
    if iszero(ok) {{ {_fail("i", "AA13 initCode failed or OOG")} }}
    let created := mload(0x00)
    if iszero(eq(created, calldataload(op))) {{
        {_fail("i", "AA14 initCode must return sender")}
    }}
    if iszero(extcodesize(created)) {{
        {_fail("i", "AA15 initCode must create sender")}
    }}
}}
function callValidateUserOp(op, hash, missing, gaslim) -> vd, ok {{
    mstore(0x10000, shl(224, 0x3a871cdd))
    mstore(0x10004, 0x60)
    mstore(0x10024, hash)
    mstore(0x10044, missing)
    let l := opLen(op)
    calldatacopy(0x10064, op, l)
    mstore(0x00, 1)
    ok := call(gaslim, calldataload(op), 0, 0x10000, add(0x64, l), 0x00, 0x20)
    vd := mload(0x00)
    if lt(returndatasize(), 32) {{ vd := 1 }}
}}
function callValidatePaymaster(op, hash, maxCost, pm, gaslim) -> vd, ok {{
    mstore(0x10000, shl(224, 0xf465c77e))
    mstore(0x10004, 0x60)
    mstore(0x10024, hash)
    mstore(0x10044, maxCost)
    let l := opLen(op)
    calldatacopy(0x10064, op, l)
    // returns (bytes context, uint256 validationData)
    ok := call(gaslim, pm, 0, 0x10000, add(0x64, l), 0x00, 0x40)
    vd := mload(0x20)
    if lt(returndatasize(), 64) {{ vd := 1 }}
}}

function runOp(i, op) -> cost {{
        // one UserOperation: validate (account/paymaster) + execute +
        // gas accounting (the shared body of handleOps and
        // handleAggregatedOps; innerHandleOp parity)
        let sender := calldataload(op)
        let g0 := gas()
        if iszero(extcodesize(sender)) {{ createSender(i, op) }}
        let hash := userOpHash(op)
        // nonce = key<<64 | seq (NonceManager parity)
        let nonce := calldataload(add(op, 32))
        let ns := nonceSlot(sender, shr(64, nonce))
        if iszero(eq(and(nonce, 0xffffffffffffffff), sload(ns))) {{
            {_fail("i", "AA25 invalid account nonce")}
        }}
        sstore(ns, add(sload(ns), 1))
        let cgl := calldataload(add(op, 128))
        let vgl := calldataload(add(op, 160))
        let pvg := calldataload(add(op, 192))
        let maxFee := calldataload(add(op, 224))
        let prefund := mul(add(add(cgl, vgl), pvg), maxFee)
        let pm := paymasterOf(op)
        let payer := sender
        switch pm
        case 0 {{
            let ds := depositSlot(sender)
            let missing := 0
            if lt(sload(ds), prefund) {{ missing := sub(prefund, sload(ds)) }}
            let vd, vok := callValidateUserOp(op, hash, missing, vgl)
            if iszero(vok) {{ {_fail("i", "AA23 reverted (or OOG)")} }}
            if vd {{ {_fail("i", "AA24 signature error")} }}
            if lt(sload(ds), prefund) {{
                {_fail("i", "AA21 didn't pay prefund")}
            }}
            sstore(ds, sub(sload(ds), prefund))
        }}
        default {{
            payer := pm
            let vd, vok := callValidateUserOp(op, hash, 0, vgl)
            if iszero(vok) {{ {_fail("i", "AA23 reverted (or OOG)")} }}
            if vd {{ {_fail("i", "AA24 signature error")} }}
            let pds := depositSlot(pm)
            if lt(sload(pds), prefund) {{
                {_fail("i", "AA31 paymaster deposit too low")}
            }}
            let pvd, pok := callValidatePaymaster(op, hash, prefund, pm, vgl)
            if iszero(pok) {{ {_fail("i", "AA33 reverted (or OOG)")} }}
            if pvd {{ {_fail("i", "AA34 signature error")} }}
            sstore(pds, sub(sload(pds), prefund))
        }}
        // execution (innerHandleOp parity: op failure does not revert)
        let cdPtr := add(op, calldataload(add(op, 96)))
        let cdLen := calldataload(cdPtr)
        calldatacopy(0x10000, add(cdPtr, 32), cdLen)
        let execOk := call(cgl, sender, 0, 0x10000, cdLen, 0, 0)
        // gas accounting: price = min(maxFee, maxPriority + basefee)
        let gasPrice := maxFee
        let pb := add(calldataload(add(op, 256)), basefee())
        if lt(pb, gasPrice) {{ gasPrice := pb }}
        let actualGas := add(sub(g0, gas()), pvg)
        cost := mul(actualGas, gasPrice)
        if gt(cost, prefund) {{ cost := prefund }}
        let rs := depositSlot(payer)
        sstore(rs, add(sload(rs), sub(prefund, cost)))
        mstore(0x100, nonce)
        mstore(0x120, execOk)
        mstore(0x140, cost)
        mstore(0x160, actualGas)
        log4(0x100, 0x80, 0x{USER_OPERATION_EVENT_TOPIC:064x},
             hash, sender, pm)
}}

// ---- dispatcher ----
if iszero(calldatasize()) {{
    // receive(): credit the caller's deposit (StakeManager receive parity)
    let ds := depositSlot(caller())
    sstore(ds, add(sload(ds), callvalue()))
    stop()
}}
switch shr(224, calldataload(0))
case 0x1fad948c {{ // handleOps(UserOperation[],address)
    let opsBase := add(4, calldataload(4))
    let beneficiary := calldataload(36)
    let nOps := calldataload(opsBase)
    let collected := 0
    for {{ let i := 0 }} lt(i, nOps) {{ i := add(i, 1) }} {{
        let op := add(add(opsBase, 32),
                      calldataload(add(add(opsBase, 32), mul(i, 32))))
        collected := add(collected, runOp(i, op))
    }}
    if iszero(call(gas(), beneficiary, collected, 0, 0, 0, 0)) {{
        revert(0, 0)
    }}
    stop()
}}
case 0x4b1d7cf5 {{ // handleAggregatedOps(UserOpsPerAggregator[],address)
    // v0.6 aggregated path (core/EntryPoint.sol:228): per group, the
    // aggregator's validateSignatures(ops, signature) must succeed
    // before the ops are processed like handleOps. Lite deviations from
    // upstream are the same as handleOps' (no 1-address unstaked check).
    let groupsBase := add(4, calldataload(4))
    let beneficiary := calldataload(36)
    let nGroups := calldataload(groupsBase)
    let collected := 0
    let opIdx := 0
    for {{ let g := 0 }} lt(g, nGroups) {{ g := add(g, 1) }} {{
        let grp := add(add(groupsBase, 32),
                       calldataload(add(add(groupsBase, 32), mul(g, 32))))
        let agg := calldataload(add(grp, 32))
        let opsPtr := add(grp, calldataload(grp))
        if agg {{
            // rebuild validateSignatures(UserOperation[],bytes) calldata:
            // the ops-array bytes are position-independent (offsets are
            // array-relative), so they copy verbatim; canonical ABI
            // encoders lay the signature tail directly after it.
            let sigPtr := add(grp, calldataload(add(grp, 64)))
            let opsLen := sub(sigPtr, opsPtr)
            let sigLen := calldataload(sigPtr)
            let M := 0x20000
            mstore(M, shl(224, 0x{VALIDATE_SIGNATURES_SELECTOR:08x}))
            mstore(add(M, 4), 0x40)
            mstore(add(M, 36), add(0x40, opsLen))
            calldatacopy(add(M, 68), opsPtr, opsLen)
            calldatacopy(add(M, add(68, opsLen)), sigPtr,
                         add(32, ceil32(sigLen)))
            let alen := add(add(68, opsLen), add(32, ceil32(sigLen)))
            if iszero(call(gas(), agg, 0, M, alen, 0, 0)) {{
                {_fail("opIdx", "AA96 invalid aggregator")}
            }}
        }}
        let nOps := calldataload(opsPtr)
        for {{ let j := 0 }} lt(j, nOps) {{ j := add(j, 1) }} {{
            let op := add(add(opsPtr, 32),
                          calldataload(add(add(opsPtr, 32), mul(j, 32))))
            collected := add(collected, runOp(opIdx, op))
            opIdx := add(opIdx, 1)
        }}
    }}
    if iszero(call(gas(), beneficiary, collected, 0, 0, 0, 0)) {{
        revert(0, 0)
    }}
    stop()
}}
case 0xb760faf9 {{ // depositTo(address)
    let ds := depositSlot(calldataload(4))
    sstore(ds, add(sload(ds), callvalue()))
    stop()
}}
case 0x70a08231 {{ // balanceOf(address)
    mstore(0, sload(depositSlot(calldataload(4))))
    return(0, 32)
}}
case 0x205c2878 {{ // withdrawTo(address,uint256)
    let to := calldataload(4)
    let amt := calldataload(36)
    let ds := depositSlot(caller())
    let bal := sload(ds)
    if lt(bal, amt) {{ revert(0, 0) }}
    sstore(ds, sub(bal, amt))
    if iszero(call(gas(), to, amt, 0, 0, 0, 0)) {{ revert(0, 0) }}
    stop()
}}
case 0x35567e1a {{ // getNonce(address,uint192)
    let key := calldataload(36)
    mstore(0, or(shl(64, key), sload(nonceSlot(calldataload(4), key))))
    return(0, 32)
}}
case 0xa6193531 {{ // getUserOpHash(UserOperation)
    mstore(0, userOpHash(add(4, calldataload(4))))
    return(0, 32)
}}
case 0x0396cb60 {{ // addStake(uint32) payable (StakeManager.sol parity)
    let delay := calldataload(4)
    if iszero(delay) {{ revert(0, 0) }}
    let si := stakeInfoSlot(caller())
    let prev := and(shr(48, sload(si)), 0xffffffff)
    if lt(delay, prev) {{ revert(0, 0) }}  // cannot decrease unstake delay
    let ss := stakeSlot(caller())
    sstore(ss, add(sload(ss), callvalue()))
    sstore(si, or(shl(255, 1), shl(48, delay)))
    stop()
}}
case 0xbb9fe6bf {{ // unlockStake()
    let si := stakeInfoSlot(caller())
    let info := sload(si)
    if iszero(shr(255, info)) {{ revert(0, 0) }}  // not staked
    let delay := and(shr(48, info), 0xffffffff)
    sstore(si, or(shl(48, delay), add(timestamp(), delay)))
    stop()
}}
case 0xc23a5cea {{ // withdrawStake(address)
    let si := stakeInfoSlot(caller())
    let info := sload(si)
    if shr(255, info) {{ revert(0, 0) }}  // must call unlockStake first
    let wt := and(info, 0xffffffffffff)
    if iszero(wt) {{ revert(0, 0) }}
    if lt(timestamp(), wt) {{ revert(0, 0) }}  // unstake delay not passed
    let ss := stakeSlot(caller())
    let amt := sload(ss)
    sstore(ss, 0)
    sstore(si, 0)
    if iszero(call(gas(), calldataload(4), amt, 0, 0, 0, 0)) {{
        revert(0, 0)
    }}
    stop()
}}
case 0x5287ce12 {{ // getDepositInfo(address) -> DepositInfo
    let a := calldataload(4)
    // load everything BEFORE building the return blob: the slot helpers
    // use 0x00-0x40 as keccak scratch and would clobber it
    let dep := sload(depositSlot(a))
    let stk := sload(stakeSlot(a))
    let info := sload(stakeInfoSlot(a))
    mstore(0x00, dep)
    mstore(0x20, shr(255, info))
    mstore(0x40, stk)
    mstore(0x60, and(shr(48, info), 0xffffffff))
    mstore(0x80, and(info, 0xffffffffffff))
    return(0, 0xa0)
}}
case 0xee219423 {{ // simulateValidation(UserOperation) — ALWAYS reverts:
    // ValidationResult(...) on success, FailedOp on validation failure
    // (core/EntryPoint.sol:503). Bundlers call this with a state
    // override / from=0 to vet ops off-chain.
    let op := add(4, calldataload(4))
    let g0 := gas()
    let sender := calldataload(op)
    if iszero(extcodesize(sender)) {{ createSender(0, op) }}
    let hash := userOpHash(op)
    let cgl := calldataload(add(op, 128))
    let vgl := calldataload(add(op, 160))
    let pvg := calldataload(add(op, 192))
    let maxFee := calldataload(add(op, 224))
    let prefund := mul(add(add(cgl, vgl), pvg), maxFee)
    let vd, vok := callValidateUserOp(op, hash, prefund, vgl)
    if iszero(vok) {{ {_fail("0", "AA23 reverted (or OOG)")} }}
    let sigFailed := iszero(iszero(vd))
    let pm := paymasterOf(op)
    if pm {{
        let pvd, pok := callValidatePaymaster(op, hash, prefund, pm, vgl)
        if iszero(pok) {{ {_fail("0", "AA33 reverted (or OOG)")} }}
        if pvd {{ sigFailed := 1 }}
    }}
    // abi: selector ++ head(offset, senderInfo, factoryInfo, pmInfo)
    //      ++ ReturnInfo tail (7 words, empty paymasterContext)
    mstore(0x100, shl(224, 0x{VALIDATION_RESULT_SELECTOR:08x}))
    mstore(0x104, 0xe0)
    mstore(0x124, sload(stakeSlot(sender)))
    let sinfo := sload(stakeInfoSlot(sender))
    mstore(0x144, and(shr(48, sinfo), 0xffffffff))
    mstore(0x164, 0)
    mstore(0x184, 0)
    mstore(0x1a4, sload(stakeSlot(pm)))
    let pinfo := sload(stakeInfoSlot(pm))
    mstore(0x1c4, and(shr(48, pinfo), 0xffffffff))
    mstore(0x1e4, add(sub(g0, gas()), pvg))
    mstore(0x204, prefund)
    mstore(0x224, sigFailed)
    mstore(0x244, 0)
    mstore(0x264, 0)
    mstore(0x284, 0xc0)
    mstore(0x2a4, 0)
    revert(0x100, 0x1c4)
}}
case 0x9b249f69 {{ // getSenderAddress(bytes initCode) — always reverts with
    // SenderAddressResult(address) (the web demo's revert-parse trick,
    // index.tsx:327-341)
    let initPtr := add(4, calldataload(4))
    let initLen := calldataload(initPtr)
    if lt(initLen, 20) {{ revert(0, 0) }}
    let factory := shr(96, calldataload(add(initPtr, 32)))
    calldatacopy(0x10000, add(initPtr, 52), sub(initLen, 20))
    let ok := call(gas(), factory, 0, 0x10000, sub(initLen, 20), 0x00, 0x20)
    if iszero(ok) {{ revert(0, 0) }}
    mstore(0x20, shl(224, 0x{SENDER_ADDRESS_RESULT_SELECTOR:08x}))
    mstore(0x24, mload(0x00))
    revert(0x20, 0x24)
}}
default {{ revert(0, 0) }}
"""


# ---------------------------------------------------------------------------
# P256Account implementation (delegatecall target behind per-account proxies)
# ---------------------------------------------------------------------------
# storage (proxy storage via delegatecall):
#   0: initialized   1: entryPoint   2: snarkVerifier
#   3: publicKey length   4,5: publicKey words (<= 64 bytes)
#   6: InactiveTimeLimit  7: inheritor  8: lastActiveTime

P256_ACCOUNT_YUL = """
// P256Account implementation (P256Account.sol parity)

function ceil32(x) -> y { y := and(add(x, 31), not(31)) }
function requireFromEntryPoint() {
    if iszero(eq(caller(), sload(1))) { revert(0, 0) }
}

if lt(calldatasize(), 4) { stop() } // receive()
switch shr(224, calldataload(0))
case 0xabf90f7b { // initialize(address entryPoint, bytes publicKey, address verifier)
    if sload(0) { revert(0, 0) } // initializer: once
    sstore(0, 1)
    sstore(1, calldataload(4))
    sstore(2, calldataload(68))
    let pkPtr := add(4, calldataload(36))
    let pkLen := calldataload(pkPtr)
    if gt(pkLen, 64) { revert(0, 0) }
    sstore(3, pkLen)
    sstore(4, calldataload(add(pkPtr, 32)))
    if gt(pkLen, 32) { sstore(5, calldataload(add(pkPtr, 64))) }
    sstore(8, timestamp()) // lastActiveTime
    stop()
}
case 0x3a871cdd { // validateUserOp(UserOperation,bytes32,uint256)
    requireFromEntryPoint()
    let op := add(4, calldataload(4))
    let missing := calldataload(68)
    // _validateSignature: the signature IS the snark-verifier calldata
    // (P256Account.sol:74-83); note the same public-input binding TODO
    // as the reference — the userOpHash is not yet bound into the proof
    let sigPtr := add(op, calldataload(add(op, 320)))
    let sigLen := calldataload(sigPtr)
    calldatacopy(0x10000, add(sigPtr, 32), sigLen)
    let ok := call(gas(), sload(2), 0, 0x10000, sigLen, 0, 0)
    // payPrefund: best-effort send, entrypoint receive() credits deposit
    if missing { pop(call(gas(), caller(), missing, 0, 0, 0, 0)) }
    mstore(0, iszero(ok)) // 0 = ok, 1 = SIG_VALIDATION_FAILED
    return(0, 32)
}
case 0xb61d27f6 { // execute(address,uint256,bytes)
    requireFromEntryPoint()
    let dPtr := add(4, calldataload(68))
    let dLen := calldataload(dPtr)
    calldatacopy(0x10000, add(dPtr, 32), dLen)
    let ok := call(gas(), calldataload(4), calldataload(36),
                   0x10000, dLen, 0, 0)
    if iszero(ok) {
        returndatacopy(0, 0, returndatasize())
        revert(0, returndatasize())
    }
    stop()
}
case 0x18dfb3c7 { // executeBatch(address[],bytes[])
    requireFromEntryPoint()
    let destBase := add(4, calldataload(4))
    let funcBase := add(4, calldataload(36))
    let n := calldataload(destBase)
    if iszero(eq(n, calldataload(funcBase))) { revert(0, 0) }
    for { let i := 0 } lt(i, n) { i := add(i, 1) } {
        let dest := calldataload(add(add(destBase, 32), mul(i, 32)))
        let fPtr := add(add(funcBase, 32),
                        calldataload(add(add(funcBase, 32), mul(i, 32))))
        let fLen := calldataload(fPtr)
        calldatacopy(0x10000, add(fPtr, 32), fLen)
        let ok := call(gas(), dest, 0, 0x10000, fLen, 0, 0)
        if iszero(ok) {
            returndatacopy(0, 0, returndatasize())
            revert(0, returndatasize())
        }
    }
    stop()
}
case 0xa91d58b4 { // setPublicKey(bytes)
    requireFromEntryPoint()
    let pkPtr := add(4, calldataload(4))
    let pkLen := calldataload(pkPtr)
    if gt(pkLen, 64) { revert(0, 0) }
    sstore(3, pkLen)
    sstore(4, calldataload(add(pkPtr, 32)))
    if gt(pkLen, 32) { sstore(5, calldataload(add(pkPtr, 64))) }
    stop()
}
case 0x8c2ebc7c { // setInactiveTimeLimit(uint256)
    requireFromEntryPoint()
    sstore(6, calldataload(4))
    stop()
}
case 0x12b22256 { // setInheritor(address)
    requireFromEntryPoint()
    sstore(7, calldataload(4))
    stop()
}
case 0x2b445d78 { // inherit() — dead-man switch (P256Account.sol:64-71)
    if iszero(eq(caller(), sload(7))) { revert(0, 0) }
    if iszero(gt(sub(timestamp(), sload(8)), sload(6))) { revert(0, 0) }
    if iszero(call(gas(), caller(), selfbalance(), 0, 0, 0, 0)) {
        revert(0, 0)
    }
    stop()
}
case 0x63ffab31 { // publicKey() returns (bytes)
    let len := sload(3)
    mstore(0x00, 0x20)
    mstore(0x20, len)
    mstore(0x40, sload(4))
    mstore(0x60, sload(5))
    return(0x00, add(0x40, ceil32(len)))
}
case 0x7a2a660b { mstore(0, sload(2)) return(0, 32) } // snarkVerifier()
case 0xb0d691fe { mstore(0, sload(1)) return(0, 32) } // entryPoint()
default { stop() } // accept unknown calls like a fallback wallet
"""


# ---------------------------------------------------------------------------
# P256AccountFactory (templated: IMPL, ENTRY_POINT, VERIFIER)
# ---------------------------------------------------------------------------

P256_ACCOUNT_FACTORY_YUL = """
// P256AccountFactory (P256AccountFactory.sol parity): CREATE2 minimal
// proxies to a shared implementation, salt = keccak(publicKey)

function ceil32(x) -> y { y := and(add(x, 31), not(31)) }
function proxyInitTo(ptr) -> len {
    // EIP-1167 minimal proxy to IMPL (55 bytes)
    mstore(ptr, shl(96, 0x3d602d80600a3d3981f3363d3d373d3d3d363d73))
    mstore(add(ptr, 20), shl(96, {IMPL}))
    mstore(add(ptr, 40), shl(136, 0x5af43d82803e903d91602b57fd5bf3))
    len := 55
}
function computeAddress(salt) -> a {
    let l := proxyInitTo(0x11000)
    let ih := keccak256(0x11000, l)
    mstore8(0x13000, 0xff)
    mstore(0x13001, shl(96, address()))
    mstore(0x13015, salt)
    mstore(0x13035, ih)
    a := and(keccak256(0x13000, 0x55),
             0xffffffffffffffffffffffffffffffffffffffff)
}

if lt(calldatasize(), 4) { revert(0, 0) }
switch shr(224, calldataload(0))
case 0xa9ea858f { // createAccount(bytes publicKey) -> address
    let pkPtr := add(4, calldataload(4))
    let pkLen := calldataload(pkPtr)
    calldatacopy(0x10000, add(pkPtr, 32), pkLen)
    let salt := keccak256(0x10000, pkLen)
    let addr := computeAddress(salt)
    if iszero(extcodesize(addr)) { // idempotent: return existing account
        let l := proxyInitTo(0x11000)
        let created := create2(0, 0x11000, l, salt)
        if iszero(created) { revert(0, 0) }
        // initialize(entryPoint, publicKey, snarkVerifier)
        mstore(0x12000, shl(224, 0xabf90f7b))
        mstore(0x12004, {ENTRY_POINT})
        mstore(0x12024, 0x60)
        mstore(0x12044, {VERIFIER})
        mstore(0x12064, pkLen)
        calldatacopy(0x12084, add(pkPtr, 32), ceil32(pkLen))
        let ok := call(gas(), created, 0, 0x12000,
                       add(0x84, ceil32(pkLen)), 0, 0)
        if iszero(ok) { revert(0, 0) }
    }
    mstore(0, addr)
    return(0, 32)
}
case 0xc47cf5de { // getAddress(bytes publicKey) — counterfactual
    let pkPtr := add(4, calldataload(4))
    let pkLen := calldataload(pkPtr)
    calldatacopy(0x10000, add(pkPtr, 32), pkLen)
    mstore(0, computeAddress(keccak256(0x10000, pkLen)))
    return(0, 32)
}
case 0x11464fbe { mstore(0, {IMPL}) return(0, 32) } // accountImplementation()
case 0xb0d691fe { mstore(0, {ENTRY_POINT}) return(0, 32) } // entryPoint()
case 0x7a2a660b { mstore(0, {VERIFIER}) return(0, 32) } // snarkVerifier()
default { revert(0, 0) }
"""


# ---------------------------------------------------------------------------
# SponsorPaymaster (templated: ENTRY_POINT, OWNER)
# ---------------------------------------------------------------------------

SPONSOR_PAYMASTER_YUL = """
// SponsorPaymaster (SponsorPaymaster.sol parity): pays for everything

function authSlot(a) -> s {
    mstore(0x00, a)
    mstore(0x20, 0)
    s := keccak256(0x00, 0x40)
}
function requireOwner() {
    if iszero(eq(caller(), {OWNER})) { revert(0, 0) }
}

if lt(calldatasize(), 4) { stop() } // receive()
switch shr(224, calldataload(0))
case 0xf465c77e { // validatePaymasterUserOp(op,hash,maxCost)
    if iszero(eq(caller(), {ENTRY_POINT})) { revert(0, 0) }
    // whitelist check intentionally NOT enforced, matching the
    // reference's commented-out require (SponsorPaymaster.sol:28-33)
    mstore(0x00, 0x40) // (bytes context = "", uint256 validationData = 0)
    mstore(0x20, 0)
    mstore(0x40, 0)
    return(0x00, 0x60)
}
case 0xa9a23409 { // postOp(uint8,bytes,uint256)
    if iszero(eq(caller(), {ENTRY_POINT})) { revert(0, 0) }
    stop()
}
case 0x177d2a74 { // addAuthorizedUser(address)
    requireOwner()
    sstore(authSlot(calldataload(4)), 1)
    stop()
}
case 0x89fabc80 { // removeAuthorizedUser(address)
    requireOwner()
    sstore(authSlot(calldataload(4)), 0)
    stop()
}
case 0xfe9fbb80 { // isAuthorized(address)
    mstore(0, sload(authSlot(calldataload(4))))
    return(0, 32)
}
case 0xd0e30db0 { // deposit() — forward to entryPoint.depositTo(this)
    mstore(0x00, shl(224, 0xb760faf9))
    mstore(0x04, address())
    if iszero(call(gas(), {ENTRY_POINT}, callvalue(), 0x00, 0x24, 0, 0)) {
        revert(0, 0)
    }
    stop()
}
case 0x205c2878 { // withdrawTo(address,uint256) — from entrypoint deposit
    requireOwner()
    mstore(0x00, shl(224, 0x205c2878))
    mstore(0x04, calldataload(4))
    mstore(0x24, calldataload(36))
    if iszero(call(gas(), {ENTRY_POINT}, 0, 0x00, 0x44, 0, 0)) {
        revert(0, 0)
    }
    stop()
}
case 0x8da5cb5b { mstore(0, {OWNER}) return(0, 32) } // owner()
default { revert(0, 0) }
"""


# Counter — the reference's end-to-end test target (contracts/src/Counter.sol)
COUNTER_YUL = """
if lt(calldatasize(), 4) { revert(0, 0) }
switch shr(224, calldataload(0))
case 0xd09de08a { sstore(0, add(sload(0), 1)) stop() }        // increment()
case 0x8381f58a { mstore(0, sload(0)) return(0, 32) }         // number()
case 0x3fb5c1cb { sstore(0, calldataload(4)) stop() }         // setNumber(uint256)
default { revert(0, 0) }
"""

# test IAggregator (interfaces/IAggregator.sol): accepts a group iff the
# aggregated signature is the 32-byte MAGIC word, and counts accepted
# groups in slot 0 (so tests can assert validateSignatures actually ran)
AGGREGATOR_MAGIC = 0xA6672E6A7ED15B5F1F3C5E1A9F0D1C2B3A49586770695A4B3C2D1E0F00112233

MOCK_AGGREGATOR_YUL = f"""
if lt(calldatasize(), 4) {{ revert(0, 0) }}
switch shr(224, calldataload(0))
case 0x{VALIDATE_SIGNATURES_SELECTOR:08x} {{
    let sigPtr := add(4, calldataload(36))
    if iszero(eq(calldataload(sigPtr), 32)) {{ revert(0, 0) }}
    if iszero(eq(calldataload(add(sigPtr, 32)),
                 0x{AGGREGATOR_MAGIC:064x})) {{ revert(0, 0) }}
    sstore(0, add(sload(0), 1))
    stop()
}}
case 0x8381f58a {{ mstore(0, sload(0)) return(0, 32) }}        // number()
default {{ revert(0, 0) }}
"""


# ---------------------------------------------------------------------------
# deployment helpers
# ---------------------------------------------------------------------------

def _addr(x: int) -> str:
    return f"0x{x:040x}"


def compile_entry_point() -> tuple[bytes, bytes]:
    from ..evm.yulc import compile_contract

    return compile_contract(ENTRY_POINT_YUL)


def compile_account_impl() -> tuple[bytes, bytes]:
    from ..evm.yulc import compile_contract

    return compile_contract(P256_ACCOUNT_YUL)


def _template(src: str, **vars_: int) -> str:
    """Bake {NAME} constructor constants (plain replace — .format would
    trip on the Yul braces)."""
    for k, v in vars_.items():
        src = src.replace("{" + k + "}", _addr(v))
    return src


def compile_factory(impl: int, entry_point: int, verifier: int
                    ) -> tuple[bytes, bytes]:
    from ..evm.yulc import compile_contract

    return compile_contract(_template(
        P256_ACCOUNT_FACTORY_YUL, IMPL=impl, ENTRY_POINT=entry_point,
        VERIFIER=verifier))


def compile_paymaster(entry_point: int, owner: int) -> tuple[bytes, bytes]:
    from ..evm.yulc import compile_contract

    return compile_contract(_template(
        SPONSOR_PAYMASTER_YUL, ENTRY_POINT=entry_point, OWNER=owner))


def compile_mock_aggregator() -> tuple[bytes, bytes]:
    from ..evm.yulc import compile_contract

    return compile_contract(MOCK_AGGREGATOR_YUL)


def compile_counter() -> tuple[bytes, bytes]:
    from ..evm.yulc import compile_contract

    return compile_contract(COUNTER_YUL)


def deploy_suite(chain, deployer: int, verifier: int) -> dict:
    """Deploy the full chain-side suite (DeployAccountFactory.s.sol
    parity): EntryPoint, account implementation, factory, paymaster.
    Returns {name: address}."""
    out: dict[str, int] = {}
    for name, (deploy, _rt) in [
        ("entry_point", compile_entry_point()),
        ("account_impl", compile_account_impl()),
    ]:
        addr, res = chain.create(deployer, deploy)
        assert res.success, f"{name} deployment failed"
        out[name] = addr
    fac_deploy, _ = compile_factory(out["account_impl"], out["entry_point"],
                                    verifier)
    addr, res = chain.create(deployer, fac_deploy)
    assert res.success, "factory deployment failed"
    out["factory"] = addr
    pay_deploy, _ = compile_paymaster(out["entry_point"], deployer)
    addr, res = chain.create(deployer, pay_deploy)
    assert res.success, "paymaster deployment failed"
    out["paymaster"] = addr
    out["verifier"] = verifier
    return out
