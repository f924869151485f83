"""Every kernel launch on the card of its tensors (ops/kernels.py).

The C entries launch on the CUDA runtime's current device, and torch keeps
a current device a thread (a new thread starts on card 0). So each kernel
wrapper finds the one card of its tensors (`kernels.card_of`) and launches
inside `kernels.on_card`, which makes that card current for the call and
restores the thread's own after. No C entry runs on the CPU, so here
torch.cuda's device calls are monkeypatched to record what they are asked,
the kernel libraries are stand-ins that record the current device at each
entry, and the tensors are CPU tensors that report a card
(`FakeCards`, a TorchFunctionMode). Each wrapper is called with its
tensors on cuda:1 from a thread whose current device is 0: every entry
must run with card 1 current and on card 1's stream, and the thread must
be back on card 0 after. Tensors on two cards, or on the CPU, raise before
any launch. `device.resolve` names a card by its index, and
`api.prove_batch`'s worker threads run on the key's card.
"""
import random
import threading

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from webauthn_halo2_tpu_torch import api
from webauthn_halo2_tpu_torch import device as D
from webauthn_halo2_tpu_torch.fields.limbs import FQ_SPEC, FR_SPEC, W
from webauthn_halo2_tpu_torch.ops import ec as E
from webauthn_halo2_tpu_torch.ops import kernels as K
from webauthn_halo2_tpu_torch.ops import modops as M
from webauthn_halo2_tpu_torch.ops import msm_fused as MF
from webauthn_halo2_tpu_torch.ops import mxu_mod as X
from webauthn_halo2_tpu_torch.ops import ntt as N

torch.set_num_threads(2)


class FakeCards(TorchFunctionMode):
    """CPU tensors that report the card they were made on: a factory or
    `.to` given a CUDA device runs on the CPU and tags its result with the
    card's index; any other op tags its results with its inputs' card;
    `.device` and `.is_cuda` of a tagged tensor report the card."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.device:  # constructing a device is not a move
            return func(*args, **kwargs)
        if func == torch.Tensor.device.__get__:
            card = getattr(args[0], "_card", None)
            return args[0].device if card is None else torch.device("cuda", card)
        if func == torch.Tensor.is_cuda.__get__:
            return getattr(args[0], "_card", None) is not None
        card = None

        def host(v):
            nonlocal card
            if isinstance(v, (str, torch.device)) and torch.device(v).type == "cuda":
                card = torch.device(v).index
                return torch.device("cpu")
            return v

        args = tuple(host(a) for a in args)
        kwargs = {k: host(v) for k, v in kwargs.items()}
        if card is None:
            card = next((getattr(t, "_card") for t in _tensors((args, kwargs))
                         if getattr(t, "_card", None) is not None), None)
        out = func(*args, **kwargs)
        if card is not None:
            for t in _tensors(out):
                t._card = card
        return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


class Runtime:
    """torch.cuda's device calls and the kernel libraries, recorded: a
    current device a thread (0 at its start), the stream of each card, and
    each C entry with the device current when it ran."""

    def __init__(self, monkeypatch):
        self.local = threading.local()
        self.set_calls = []
        self.entries = []
        monkeypatch.setattr(torch.cuda, "current_device", self.current_device)
        monkeypatch.setattr(torch.cuda, "set_device", self.set_device)
        monkeypatch.setattr(torch.cuda, "current_stream", self.current_stream)
        monkeypatch.setattr(K, "lib", lambda name: _Library(name, self))
        monkeypatch.setattr(D, "_CACHE", {})  # no fake card's constants kept

    def current_device(self) -> int:
        return getattr(self.local, "device", 0)

    def set_device(self, device) -> None:
        index = device if isinstance(device, int) else torch.device(device).index
        self.set_calls.append(index)
        self.local.device = index

    def current_stream(self, device=None):
        index = self.current_device() if device is None else torch.device(device).index
        return _Stream(index)


class _Stream:
    def __init__(self, index: int):
        self.cuda_stream = 1000 + index

    def synchronize(self) -> None:
        pass


class _Library:
    def __init__(self, name: str, runtime: Runtime):
        self.name, self.runtime = name, runtime

    def __getattr__(self, entry: str):
        def call(*args):
            self.runtime.entries.append((entry, self.runtime.current_device(), args[-1]))
            return 0
        return call


@pytest.fixture
def runtime(monkeypatch):
    return Runtime(monkeypatch)


def _words(spec, shape, seed: int = 1) -> torch.Tensor:
    rng = random.Random(seed)
    vals = [rng.randrange(spec.p) for _ in range(int(np.prod(shape)))]
    return torch.as_tensor(spec.encode(vals)).reshape((W,) + shape)


def _on(card: int, *tensors):
    """The tensors moved to a fake card (inside FakeCards)."""
    return [t.clone().to(f"cuda:{card}") for t in tensors]


def _launch_every_wrapper():
    """Each kernel wrapper once, its tensors on cuda:1."""
    a, b = _on(1, _words(FR_SPEC, (64,)), _words(FR_SPEC, (64,), 2))
    M.montmul_cuda(FR_SPEC, a, b)
    x, tw = _on(1, _words(FR_SPEC, (2, 64)), _words(FR_SPEC, (63,), 3))
    N.stage_a(FR_SPEC, x.contiguous(), tw, 6)
    N.stage_b(FR_SPEC, x.contiguous(), tw, 3)
    px, py = _on(1, _words(FQ_SPEC, (64,)), _words(FQ_SPEC, (64,), 4))
    sdig, order = _on(1, torch.ones((2, 4, 8), dtype=torch.int32),
                      torch.zeros((2, 4, 8), dtype=torch.int32))
    buckets, bnd, seg = MF.interior_cuda(E.BN254_CURVE, px, py, sdig, order, 16)
    MF.scan_cuda(E.BN254_CURVE, bnd, seg)
    MF.combine_cuda(E.BN254_CURVE, buckets)
    p = E.JPoint(*_on(1, *(_words(FQ_SPEC, (4, 8), s) for s in (5, 6, 7))))
    E.add_unsafe_cuda(E.BN254_CURVE, p, p)
    X.mxu_montmul_rows_cuda(FR_SPEC, a, b)
    X.mma_tile(*_on(1, torch.zeros((16, 32), dtype=torch.uint8),
                    torch.zeros((8, 32), dtype=torch.uint8)))


def test_on_card_makes_the_given_card_current_and_restores_the_threads(runtime):
    with K.on_card(torch.device("cuda", 1)) as stream:
        assert runtime.current_device() == 1
        assert stream == 1001
    assert runtime.current_device() == 0
    assert runtime.set_calls == [1, 0]
    runtime.set_calls.clear()
    with K.on_card(torch.device("cuda", 0)) as stream:  # already current: no switch
        assert stream == 1000
    assert runtime.set_calls == []
    with pytest.raises(RuntimeError):
        with K.on_card(torch.device("cuda", 2)):
            raise RuntimeError("a failed launch")
    assert runtime.current_device() == 0  # restored on the way out of a failure too
    for bad in (torch.device("cuda"), torch.device("cpu")):
        with pytest.raises(ValueError):
            with K.on_card(bad):
                pass


def test_every_wrapper_launches_on_its_tensors_card(runtime):
    with FakeCards():
        _launch_every_wrapper()
    names = [e[0] for e in runtime.entries]
    assert names == ["wh2_montmul", "wh2_ntt_stage_a", "wh2_ntt_stage_b", "wh2_msm_interior",
                     "wh2_msm_scan", "wh2_msm_combine_chunks", "wh2_msm_combine_rows",
                     "wh2_ec_add_unsafe", "wh2_mxu_montmul", "wh2_mma_tile"]
    assert all(dev == 1 and stream == 1001 for _, dev, stream in runtime.entries), runtime.entries
    assert runtime.current_device() == 0


def test_a_wrapper_in_a_thread_on_another_card_launches_on_its_tensors_card(runtime):
    errors = []

    def work():
        try:
            runtime.set_device(3)  # this thread's own card
            with FakeCards():
                _launch_every_wrapper()
            assert runtime.current_device() == 3
        except Exception as e:  # noqa: BLE001 - read below
            errors.append(e)

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    assert runtime.entries and all(dev == 1 for _, dev, _ in runtime.entries)


def test_tensors_on_two_cards_or_the_cpu_raise_before_any_launch(runtime):
    with FakeCards():
        a = _words(FR_SPEC, (64,))
        (on1,), (on2,) = _on(1, a), _on(2, a)
        for x, y in ((on1, on2), (on1, a)):
            with pytest.raises(ValueError, match="one card"):
                M.montmul_cuda(FR_SPEC, x, y)
            with pytest.raises(ValueError, match="one card"):
                X.mxu_montmul_rows_cuda(FR_SPEC, x, y)
        with pytest.raises(ValueError, match="one card"):
            N.stage_b(FR_SPEC, on1.reshape(W, 1, 64), _on(2, _words(FR_SPEC, (63,)))[0], 3)
        p = E.JPoint(on1, on1, on1)
        with pytest.raises(ValueError, match="one card"):
            E.add_unsafe_cuda(E.BN254_CURVE, p, E.JPoint(on1, on1, on2))
    assert runtime.entries == []


def test_card_of_names_the_one_card():
    class T:
        def __init__(self, device):
            self.device = torch.device(device)

    assert K.card_of("x", T("cuda:1"), T("cuda:1")) == torch.device("cuda", 1)
    for devices in (("cuda:0", "cuda:1"), ("cpu",), ("cuda:1", "cpu")):
        with pytest.raises(ValueError, match="one card"):
            K.card_of("x", *(T(d) for d in devices))


def test_resolve_names_a_card_by_its_index(monkeypatch, runtime):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    runtime.set_device(2)
    assert D.resolve(None) == D.resolve("cuda") == torch.device("cuda", 2)
    assert D.resolve("cuda:1") == torch.device("cuda", 1)
    assert D.resolve("cpu") == torch.device("cpu")


def test_prove_batch_runs_its_threads_on_the_keys_card(monkeypatch, runtime):
    """The witness and prover threads start on card 0, as torch's new
    threads do; each must make the key's card (cuda:1) current first."""
    seen = []

    class Pk:
        device = torch.device("cuda", 1)

    def witness():
        seen.append(("witness", runtime.current_device()))
        return [], []

    def create_proof(pk, advice, instances, rng, device, **opening):
        seen.append(("prover", runtime.current_device(), device))
        return b"proof"

    monkeypatch.setattr(api, "_fused_for", lambda pk: None)
    monkeypatch.setattr(api, "create_proof", create_proof)
    monkeypatch.setattr(api, "_STREAMS", {})
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev: _StreamStub())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: _NullContext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _StreamStub())
    assert api.prove_batch(Pk(), [witness] * 3) == [b"proof"] * 3
    assert sorted(seen) == [("prover", 1, Pk.device)] * 3 + [("witness", 1)] * 3


class _StreamStub:
    def wait_stream(self, other) -> None:
        pass


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
