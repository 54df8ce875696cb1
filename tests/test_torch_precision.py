"""The port's float32 products keep the reference's results whatever
float32 precision the caller has set for torch (``cplx.exact_fp32``).

A caller may set it three ways: ``torch.set_float32_matmul_precision``
(``"high"`` turns on TF32, ``"medium"`` also bf16 in oneDNN on the
CPU), the legacy ``allow_tf32`` flags, or the per-backend
``fp32_precision`` of torch's newer API. Once the newer API has been
used, a read of a legacy flag raises, so a fixture puts every setting
back through the setters after each test and reads nothing in a mixed
state.

(a) under the newer API's ``"tf32"``, ``crc32_bytes`` and a small
    ``receive_many`` run and equal their runs without it;
(b) under ``"medium"`` and under oneDNN's ``"bf16"``, ``dft_pair``
    equals the JAX ``dft_pair`` within rtol = atol = 1e-5;
(c) inside the guard, nested or not, every per-backend setting reads
    ``"ieee"`` (the legacy branch, for a torch without the newer API:
    TF32 off and the matmul precision ``"highest"``); after it each
    reads as the caller set it, through each API;
(d) two threads interleave through the guard with the caller's TF32
    on: the settings stay IEEE while either is inside, and the caller's
    come back once both have left; then many threads at once;
(e) captures 3, 5 and 6 of ``test_torch_lowsnr.py``'s corpus (3 dB at
    18, 36 and 48 Mbit/s) give ``receive_many`` results under
    ``"medium"`` field for field equal to those under the default;
(f) every float32 product of ``ziria_tpu_torch/`` (``@``, ``mm``,
    ``matmul``, ``einsum``, a convolution) lies inside ``exact_fp32`` or
    its function is listed in :data:`UNGUARDED` with the reason.

(b) and (e) show the fault only on a CPU whose oneDNN runs bf16
(``avx512_bf16`` or ``amx_bf16``): elsewhere ``"medium"`` leaves the
products exact and they pass either way. (c), (d) and (f) hold on any
CPU. ``chip_smoke.py``'s precision phase holds the same on the card.
"""

import ast
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_lowsnr import lowsnr_corpus
from test_torch_receive import _same_results
from test_torch_rx import _channel
from ziria_tpu.ops import cplx as jcplx
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.ops import cplx, crc
from ziria_tpu_torch.phy.wifi import tx

PORT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ziria_tpu_torch")

#: (file under ziria_tpu_torch/, function) -> why its products need no
#: guard
UNGUARDED = {
    ("ops/crc.py", "_orbit"):
        "numpy uint8 products mod 2 on the host: torch's settings do not "
        "reach numpy",
    ("ops/fxp.py", "_gemm_q14"):
        "float64 products: TF32 and bf16 apply to float32 only",
    ("frontend/gf2.py", "_IterMap.compose"):
        "numpy GF(2) products of 0/1 integers on the host",
}


#: the per-backend settings of torch's newer API, read here on their
#: own (not through the guard's module)
FLAGS = (("cuda", "matmul"), ("cudnn", "conv"), ("mkldnn", "matmul"),
         ("mkldnn", "conv"))


def _handles():
    return [getattr(getattr(torch.backends, b), op) for b, op in FLAGS]


def _reads():
    return [h.fp32_precision for h in _handles()]


def _reset(before):
    """Every setting back to its default through the setters (the
    legacy ones also write the newer API), then the newer API's as read
    in `before`."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = True
    for h, v in zip(_handles(), before):
        h.fp32_precision = v


@pytest.fixture(autouse=True)
def caller_flags():
    before = _reads()
    yield before
    _reset(before)


def _tf32_new_api():
    h = _handles()
    h[0].fp32_precision = "tf32"          # cuda.matmul
    h[1].fp32_precision = "tf32"          # cudnn.conv


def _captures():
    rng = np.random.default_rng(16)
    caps = []
    for m in (6, 54):
        psdu = rng.integers(0, 256, 60).astype(np.uint8)
        s = tx.encode_frame(psdu, m, add_fcs=True, device="cpu").numpy()
        caps.append(_channel(rng, s, int(rng.integers(5, 200)), 1e-3))
    return caps


def test_new_api_tf32_leaves_the_entry_points_running_and_equal():
    data = np.frombuffer(b"123456789", np.uint8).copy()
    caps = _captures()
    want_crc = crc.crc32_bytes(data)
    want = framebatch.receive_many(caps, check_fcs=True, device="cpu")
    _tf32_new_api()
    as_set = _reads()
    got_crc = crc.crc32_bytes(data)
    assert int(got_crc) == int(want_crc) == 0xCBF43926
    _same_results(framebatch.receive_many(caps, check_fcs=True,
                                          device="cpu"), want)
    assert all(g.crc_ok for g in want)
    assert _reads() == as_set


def test_dft_under_bf16_equals_reference(caller_flags):
    x = np.random.default_rng(7).standard_normal((256, 64, 2)) \
        .astype(np.float32)

    def medium():
        torch.set_float32_matmul_precision("medium")

    def onednn_bf16():
        torch.backends.mkldnn.matmul.fp32_precision = "bf16"

    for setting in (medium, onednn_bf16):
        setting()
        for inverse in (False, True):
            np.testing.assert_allclose(
                cplx.dft_pair(torch.from_numpy(x), inverse=inverse).numpy(),
                np.asarray(jcplx.dft_pair(x, inverse=inverse)),
                rtol=1e-5, atol=1e-5, err_msg=setting.__name__)
        _reset(caller_flags)


def test_guard_holds_ieee_and_restores_each_api(caller_flags, monkeypatch):
    b = torch.backends

    def new_api():
        for h, v in zip(_handles(), ("tf32", "tf32", "bf16", "bf16")):
            h.fp32_precision = v
        return _reads

    def matmul_medium():
        torch.set_float32_matmul_precision("medium")
        return torch.get_float32_matmul_precision

    def legacy():
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = True, False
        return lambda: (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)

    ieee = ["ieee"] * len(FLAGS)
    for setting in (new_api, matmul_medium, legacy):
        caller_read = setting()
        as_set, flags = caller_read(), _reads()
        assert flags != ieee, setting.__name__
        with cplx.exact_fp32():
            assert _reads() == ieee, setting.__name__
            with cplx.exact_fp32():
                assert _reads() == ieee, setting.__name__
            assert _reads() == ieee, setting.__name__
        assert (caller_read(), _reads()) == (as_set, flags), \
            setting.__name__
        _reset(caller_flags)

    # a torch without the newer API: the legacy flags and the matmul
    # precision
    monkeypatch.setattr(cplx, "precision_handles", lambda: None)
    torch.set_float32_matmul_precision("medium")

    def legacy_reads():
        return (torch.get_float32_matmul_precision(),
                b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    assert legacy_reads() == ("medium", True, True)
    with cplx.exact_fp32():
        with cplx.exact_fp32():
            assert legacy_reads() == ("highest", False, False)
        assert legacy_reads() == ("highest", False, False)
    assert legacy_reads() == ("medium", True, True)


def _join(*threads):
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()


def test_guard_across_threads():
    _tf32_new_api()
    caller = _reads()
    ieee = ["ieee"] * len(caller)
    for a_leaves_first in (True, False):
        inside = {k: threading.Event() for k in "ab"}
        leave = {k: threading.Event() for k in "ab"}

        def body(k):
            with cplx.exact_fp32():
                inside[k].set()
                leave[k].wait(30)
        ts = {k: threading.Thread(target=body, args=(k,)) for k in "ab"}
        ts["a"].start()
        assert inside["a"].wait(30) and _reads() == ieee
        ts["b"].start()
        assert inside["b"].wait(30) and _reads() == ieee
        first, second = "ab" if a_leaves_first else "ba"
        leave[first].set()
        _join(ts[first])
        assert _reads() == ieee          # the other thread is inside
        leave[second].set()
        _join(ts[second])
        assert _reads() == caller

    # more threads than cores, switching often: never a lost entry
    bad, switch = [], sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def churn():
        for _ in range(200):
            with cplx.exact_fp32():
                with cplx.exact_fp32():
                    if _reads() != ieee:
                        bad.append(_reads())
    try:
        ts = [threading.Thread(target=churn)
              for _ in range(2 * (os.cpu_count() or 1))]
        for t in ts:
            t.start()
        _join(*ts)
    finally:
        sys.setswitchinterval(switch)
    assert not bad and _reads() == caller and cplx._depth == 0


def test_low_snr_captures_under_medium_equal_default():
    caps = [lowsnr_corpus()[i] for i in (3, 5, 6)]
    want = framebatch.receive_many(caps, check_fcs=True, device="cpu")
    torch.set_float32_matmul_precision("medium")
    _same_results(framebatch.receive_many(caps, check_fcs=True,
                                          device="cpu"), want)


_PRODUCT = re.compile(r"^(mm|bmm|matmul|einsum|linear|addmm|baddbmm|"
                      r"tensordot|conv\dd|conv_transpose\dd|convolution)$")


def _is_product(node) -> bool:
    if isinstance(node, ast.BinOp):
        return isinstance(node.op, ast.MatMult)
    if isinstance(node, ast.Call):
        f = node.func
        name = getattr(f, "attr", getattr(f, "id", None))
        return bool(name and _PRODUCT.match(name))
    return False


def _enters_guard(node) -> bool:
    if not isinstance(node, ast.With):
        return False
    for item in node.items:
        f = item.context_expr
        f = f.func if isinstance(f, ast.Call) else f
        if getattr(f, "attr", getattr(f, "id", None)) == "exact_fp32":
            return True
    return False


def _unguarded(node, qual, guarded, out):
    """(function, line) of each product under `node` outside a
    ``with exact_fp32()`` of its own function."""
    for ch in ast.iter_child_nodes(node):
        if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            _unguarded(ch, qual + [ch.name], False, out)
            continue
        if _is_product(ch) and not guarded:
            out.append((".".join(qual), ch.lineno))
        _unguarded(ch, qual, guarded or _enters_guard(ch), out)


def test_every_float32_product_is_guarded_or_listed():
    found = {}
    for dirpath, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    tree = ast.parse(fh.read())
                out = []
                _unguarded(tree, [], False, out)
                rel = os.path.relpath(path, PORT).replace(os.sep, "/")
                for fn, line in out:
                    found.setdefault((rel, fn), []).append(line)
    missing = {k: v for k, v in found.items() if k not in UNGUARDED}
    assert not missing, f"products outside exact_fp32: {missing}"
    stale = set(UNGUARDED) - set(found)
    assert not stale, f"listed but holding no unguarded product: {stale}"
