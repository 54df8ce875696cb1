"""The port's entry points that take a mesh, on virtual CPU entries: the
sharded fleet (MultiStreamReceiver / receive_streams(mesh=)), the sharded
BER sweep, the server's ``ServeConfig.shard`` and the CLI's ``--sp``,
``--pp`` and ``--pp-costs``.

The fleet is held to the reference's *unsharded* fleet (its own sharded
fleet test fails under jax 0.9.0) and to the port's unsharded fleet,
frame for frame; the sweep to the reference's ``sweep_ber_sharded`` on
its 8 virtual devices, count for count; the CLI's outputs to the
reference CLI's on the files of tests/test_streampar.py and
tests/test_autosplit.py, byte for byte, with its error messages."""

import numpy as np
import pytest
import torch

from test_torch_fleet import GEO, S, fleet_streams, same_frames
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.backend import framebatch as jfb
from ziria_tpu.phy import link as jlink
from ziria_tpu.parallel import batch as jbatch
from ziria_tpu_torch.backend import framebatch
from ziria_tpu_torch.parallel import mesh as pmesh
from ziria_tpu_torch.phy import link
from ziria_tpu_torch.phy.wifi import rx
from ziria_tpu_torch.runtime import serve
from ziria_tpu_torch.utils import dispatch, faults


def dp(n):
    return pmesh.Mesh(["cpu"] * n, ("dp",))


@pytest.fixture(scope="module")
def fleets():
    """The 8 test streams through the reference's unsharded fleet and
    the port's unsharded fleet (frames, stats, dispatch counts)."""
    streams, starts = fleet_streams()
    ref, _ = jfb.receive_streams(streams, **GEO)
    with dispatch.count_dispatches() as d:
        per, st = framebatch.receive_streams(streams, **GEO, device="cpu")
    return streams, starts, ref, (per, st, dict(d.counts))


def test_sharded_fleet_equals_the_unsharded_fleets(fleets):
    """On 8 entries (a stream each) and on 4 (two each), the sharded
    fleet's frames equal the reference's unsharded fleet and the port's,
    with the same stats and one scan and at most one decode dispatch a
    chunk-step; each shard's scan and decode run on its own streams."""
    streams, starts, ref, (per, st, counts) = fleets
    for n in (8, 4):
        seen = []
        real = rx.stream_decode_multi_graph

        def spy(segs, *a, **k):
            seen.append(int(segs.shape[0]))
            return real(segs, *a, **k)
        rx.stream_decode_multi_graph = spy
        try:
            with dispatch.count_dispatches() as d:
                got, gst = framebatch.receive_streams(
                    streams, mesh=dp(n), **GEO, device="cpu")
        finally:
            rx.stream_decode_multi_graph = real
        for i in range(S):
            same_frames(got[i], ref[i])
            same_frames(got[i], per[i])
            assert [f.start for f in got[i]] == starts[i]
        assert tuple(gst) == tuple(st) and dict(d.counts) == counts
        assert seen and set(seen) == {S // n}
        assert len(seen) == n * counts["rx.stream_decode_multi"]


def test_sharded_fleet_fused_checkpoint_and_degraded_scan(fleets):
    """fused_demap on 4 entries equals the port's unsharded fused fleet;
    a sharded fleet's lane checkpoint resumes in an unsharded one; an
    injected scan fault degrades to the unsharded eager scan with the
    same frames; on a fleet with the card's rule (``_strict``) a shard
    whose decode fails raises."""
    streams, _starts, _ref, (per, _st, _c) = fleets
    fused, _ = framebatch.receive_streams(streams, **GEO, fused_demap=True,
                                          device="cpu")
    got, _ = framebatch.receive_streams(streams, mesh=dp(4), **GEO,
                                        fused_demap=True, device="cpu")
    for i in range(S):
        same_frames(got[i], fused[i])
    msr = framebatch.MultiStreamReceiver(S, mesh=dp(2), **GEO, device="cpu")
    half = [x[: x.shape[0] // 2] for x in streams]
    out = msr.push_many(half)
    blob, drained = msr.checkpoint(1)
    out += drained
    rest = framebatch.MultiStreamReceiver(S, **GEO, device="cpu")
    out1 = [f for i, f in out if i == 1]
    out1 += [f for i, f in rest.restore_stream(1, blob) if i == 1]
    out1 += [f for i, f in rest.push(1, streams[1][half[1].shape[0]:])
             + rest.flush() if i == 1]
    same_frames(sorted(out1, key=lambda f: f.start), per[1])
    with faults.inject(faults.FaultSpec("rx.stream_chunk_multi", "fatal",
                                        calls=(0,))):
        got, gst = framebatch.receive_streams(streams, mesh=dp(4), **GEO,
                                              device="cpu")
    assert gst.degraded
    for i in range(S):
        same_frames(got[i], per[i])
    msr = framebatch.MultiStreamReceiver(S, mesh=dp(4), **GEO, device="cpu")
    msr._strict = True
    calls = []
    real = rx.stream_decode_multi_graph

    def fail_second(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("shard 1 decode failed")
        return real(*a, **k)
    rx.stream_decode_multi_graph = fail_second
    try:
        with pytest.raises(Exception, match="shard 1 decode failed"):
            msr.push_many(streams)
            msr.flush()
    finally:
        rx.stream_decode_multi_graph = real


def test_sharded_sweep_equals_the_reference():
    """sweep_ber_sharded over 8 lanes on 8 entries (each drawing the keys
    of its global lane) counts what the reference's sweep_ber_sharded
    counts on its 8 virtual devices and what the port's sweep_ber
    counts, on 4 entries too; a failing shard raises (no degraded
    twin)."""
    psdus = np.random.default_rng(9).integers(0, 256, (8, 40)) \
        .astype(np.uint8)
    args = (psdus, [6], [0.0, 6.0], [0])
    got = link.sweep_ber_sharded(*args, device="cpu")
    want = jlink.sweep_ber_sharded(*args, mesh=jbatch.frame_mesh())
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0] > 0 and got[0, 1, 0] < got[0, 0, 0]
    np.testing.assert_array_equal(got, link.sweep_ber(*args, device="cpu"))
    np.testing.assert_array_equal(
        link.sweep_ber_sharded(*args, mesh=dp(4), device="cpu"), got)
    real = link._sweep_points
    seen = []

    def flaky(*a, **k):
        seen.append(1)
        if len(seen) == 3:
            raise RuntimeError("shard 2 failed")
        return real(*a, **k)
    link._sweep_points = flaky
    try:
        with pytest.raises(RuntimeError, match="shard 2 failed"):
            link.sweep_ber_sharded(*args, mesh=dp(4), device="cpu")
    finally:
        link._sweep_points = real


def test_serve_shard_equals_unsharded(fleets):
    """ServeConfig.shard puts the lanes on the elastic mesh (4 lanes: 4
    CPU entries); its sessions' frames equal shard=False's."""
    streams, _starts, _ref, _port = fleets
    rng = np.random.default_rng(8)
    clients = []
    for i, x in enumerate(streams[:4]):
        cuts = np.cumsum(rng.integers(300, 2500, 40))
        cuts = [0] + [int(c) for c in cuts if c < x.shape[0]] + [x.shape[0]]
        sched = [(j, x[a:b]) for j, (a, b) in enumerate(zip(cuts, cuts[1:]))]
        clients.append(serve.ClientSpec(f"c{i}", sched, x))
    frames = []
    for shard in (True, False):
        cfg = serve.ServeConfig(n_lanes=4, queue_cap=4, shard=shard, **GEO)
        with serve.ServeRuntime(cfg, device="cpu") as srv:
            assert (srv._rx.mesh is not None) == shard
            assert not shard or srv._rx.mesh.size == 4
            frames.append(serve.run_clients(srv, clients))
    for c in clients:
        same_frames(frames[0][c.sid], frames[1][c.sid])
    assert sum(len(v) for v in frames[0].values()) > 0


SQ = """
fun sq(x: int32) : int32 { return x * x }
let comp main = read[int32] >>> map sq >>> write[int32]
"""
PIPE2 = """
fun inc(x: int32) : int32 { return x + 1 }
fun dbl(x: int32) : int32 { return x * 2 }
let comp main = read[int32] >>> map inc |>>>| map dbl >>> write[int32]
"""
CHAIN = """
fun f1(x: int32) : int32 { return x * 2 }
fun f2(x: int32) : int32 { return x + 7 }
fun f3(x: int32) : int32 { return x ^ 21 }
fun f4(x: int32) : int32 { return x - 3 }
let comp main = read[int32] >>> map f1 >>> map f2 >>> map f3
                >>> map f4 >>> write[int32]
"""
ACC = """
let comp main = read[int32] >>> {
  var s : int32 := 0;
  repeat { x <- take; do { s := s + x }; emit s }
} >>> write[int32]
"""


def test_cli_mesh_flags_equal_the_reference_cli(tmp_path):
    """--sp=8, --pp=2 on a ragged length and on fewer items than a macro
    chunk, --pp=4 and --pp=4 --pp-costs=measured write what the
    reference's CLI writes and what the run without the flags writes;
    the refusals carry the reference's messages."""
    from ziria_tpu.runtime.cli import main as jmain
    from ziria_tpu_torch.runtime import cli

    def files(name, src, xs):
        p = tmp_path / f"{name}.zir"
        p.write_text(src)
        inf = tmp_path / f"{name}.in"
        inf.write_text(",".join(map(str, xs)))
        return [f"--src={p}", "--input=file", f"--input-file-name={inf}",
                "--input-file-mode=dbg", "--output=file",
                "--output-file-mode=dbg"]

    def out(main, base, tag, *extra):
        f = tmp_path / f"{tag}.out"
        assert main(base + [f"--output-file-name={f}", *extra]) == 0
        return f.read_text()

    cases = [
        (files("sq", SQ, range(8 * 100 + 3)), ["--sp=8"], []),
        (files("p", PIPE2, [(i * 3) % 257 for i in range(8 * 16 + 11)]),
         ["--pp=2", "--width=8"], []),
        (files("short", PIPE2, range(5)), ["--pp=2", "--width=8"], []),
        (files("chain", CHAIN, range(4 * 2048)), ["--pp=4"], ["--width=8"]),
        (files("chain", CHAIN, range(4 * 2048)),
         ["--pp=4", "--pp-costs=measured"], ["--width=8"])]
    for k, (base, flags, common) in enumerate(cases):
        port = out(cli.main, base, f"port{k}", "--platform=cpu", *flags,
                   *common)
        assert port == out(jmain, base, f"ref{k}", *flags, *common), flags
        assert port == out(cli.main, base, f"plain{k}", "--platform=cpu",
                           *common), flags
        assert cli.LAST_RUN["backend"] in ("jit", "hybrid")
    base = files("sq", SQ, [1, 2, 3])
    acc = files("acc", ACC, range(64))
    for argv in (base + ["--output-file-name=o", "--sp=0"],
                 base + ["--output-file-name=o", "--sp=8",
                         "--backend=hybrid"],
                 base + ["--output-file-name=o", "--sp=8", "--profile"],
                 base + ["--output-file-name=o", "--pp=0"],
                 base + ["--output-file-name=o", "--pp=2", "--sp=2"],
                 acc + ["--output-file-name=o", "--sp=8"]):
        msgs = []
        for main, extra in ((cli.main, ["--platform=cpu"]), (jmain, [])):
            with pytest.raises(SystemExit) as e:
                main(argv + extra)
            msgs.append(str(e.value).split(":")[0])
        assert msgs[0] == msgs[1], argv
    with pytest.raises(SystemExit, match="--sp=9: need 9 devices"):
        cli.main(base + ["--output-file-name=o", "--sp=9", "--platform=cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(base + ["--output-file-name=o", "--sp=1"])
