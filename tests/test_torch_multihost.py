"""Several processes for the port (ziria_tpu_torch/parallel/multihost.py
over ``torch.distributed``): the bring-up's three modes, meshes that know
each entry's process and the reference's layout rules (dp process-major
and a multiple of the process count, pp inside one process), against
the JAX package's ``build_mesh``/``mesh_info`` on its 8 virtual
devices; then one real run of two gloo ranks on the CPU, whose dp
gather, sharded sweep and dp x sp batch equal the one-process
results."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import ziria_tpu as jz
import ziria_tpu_torch as z
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.parallel import build_mesh as jbuild_mesh, \
    lower_stage_parallel as jlower_pp, mesh_info as jmesh_info, \
    shard_batch as jshard_batch
from ziria_tpu_torch.parallel import build_mesh, init_multihost, \
    lower_stage_parallel, mesh_info
from ziria_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: one rank of the two-process run: its results go to an .npz per rank
RANK = r"""
import sys
import numpy as np
import torch
from ziria_tpu_torch.parallel import batch, build_mesh, init_multihost, \
    mesh_info, stream_parallel_batched
from ziria_tpu_torch.parallel import multihost
import ziria_tpu_torch as z
from ziria_tpu_torch.phy import link

torch.set_num_threads(1)
port, rank, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
assert init_multihost(f"127.0.0.1:{port}", 2, rank, device="cpu",
                      timeout_s=60)
mesh = build_mesh(dp=2, pp=1, devices=[(0, "cpu"), (1, "cpu")])
x = np.arange(4 * 32, dtype=np.float32).reshape(4, 32)
gathered = batch.data_parallel(lambda a: (a * 2).sum(-1), mesh)(x).numpy()
psdus = np.random.default_rng(9).integers(0, 256, (4, 30)).astype(np.uint8)
counts = link.sweep_ber_sharded(psdus, [6, 54], [0.0, 6.0], [0, 1],
                                mesh=mesh, device="cpu")
prog = z.pipe(z.zmap(lambda v: v * 2 + 1, name="aff"),
              z.map_accum(lambda s, v: (s + 1, v + s), 3, name="ctr",
                          advance=lambda s, n: s + n))
frames = np.arange(4 * 133, dtype=np.int32).reshape(4, 133) % 97
ys = stream_parallel_batched(prog, frames, build_mesh(
    dp=2, pp=4, axis_names=("dp", "sp"),
    devices=[(r, "cpu") for r in (0, 1) for _ in range(4)]))
info = mesh_info(mesh)
np.savez(out, gathered=gathered, counts=counts, ys=ys,
         n_processes=info["n_processes"], dcn=",".join(info["dcn_axes"]))
multihost.shutdown_multihost()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_bring_up_modes_and_layouts():
    """No arguments (or one process and no coordinator) is a no-op;
    explicit arguments must come together; build_mesh's shapes, layouts,
    info and too-few-devices message are the reference's; the process
    rules: dp a multiple of the process count, each process holding
    dp/n x pp entries, dp the axis that crosses processes."""
    assert init_multihost() is False
    assert init_multihost(num_processes=1) is False
    with pytest.raises(ValueError, match="together"):
        init_multihost("127.0.0.1:1", num_processes=2)
    mesh = build_mesh(dp=2, pp=4, device="cpu")
    assert mesh.devices.shape == (2, 4) and mesh.axis_names == ("dp", "pp")
    assert mesh_info(mesh) == jmesh_info(jbuild_mesh(dp=2, pp=4)) == \
        {"shape": {"dp": 2, "pp": 4}, "n_processes": 1, "dcn_axes": []}
    msgs = []
    for fn, kw in ((build_mesh, {"device": "cpu"}), (jbuild_mesh, {})):
        with pytest.raises(ValueError) as e:
            fn(dp=4, pp=4, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "needs 16" in msgs[0]
    for dp, pp in ((1, 8), (8, 1), (4, 2)):
        assert build_mesh(dp=dp, pp=pp, device="cpu").size == 8
    two = [(r, "cpu") for r in (0, 1) for _ in range(4)]
    m = build_mesh(dp=4, pp=2, devices=two)
    assert mesh_info(m) == {"shape": {"dp": 4, "pp": 2}, "n_processes": 2,
                            "dcn_axes": ["dp"]}
    assert [int(r) for r in m.ranks[:, 0]] == [0, 0, 1, 1]
    with pytest.raises(ValueError, match="multiple of the process count"):
        build_mesh(dp=3, pp=2, devices=two[:2] + two[4:8])
    with pytest.raises(ValueError, match="must hold"):
        build_mesh(dp=2, pp=3, devices=two[:2] + two[4:8])


def test_built_mesh_drives_dp_x_pp_like_the_reference():
    """The (dp 2, pp 4) mesh runs the batched stage pipeline, equal to
    the reference's on its built mesh and to the sequential sums."""
    def stages(d):
        return [d.zmap(lambda x: x * 2.0, name="s0"),
                d.map_accum(lambda s, x: (s + x, s + x), 0.0,
                            name="cumsum"),
                d.zmap(lambda x: x + 1.0, name="s2"),
                d.zmap(lambda x: x * 0.5, name="s3")]
    pp = lower_stage_parallel(z.par_pipe(*stages(z)),
                              build_mesh(dp=2, pp=4, device="cpu"),
                              width=4, batch_axis="dp")
    jm = jbuild_mesh(dp=2, pp=4)
    jpp = jlower_pp(jz.par_pipe(*stages(jz)), jm, width=4, batch_axis="dp")
    xs = np.random.default_rng(1).normal(size=(4, 5, pp.take)) \
        .astype(np.float32)
    ys = pp.run(xs)
    np.testing.assert_allclose(
        ys, np.asarray(jpp.run(jshard_batch(jm, xs, axis="dp"))),
        rtol=1e-5, atol=1e-5)
    want = (np.cumsum(xs.reshape(4, -1) * 2.0, axis=1) + 1.0) * 0.5
    np.testing.assert_allclose(ys.reshape(4, -1), want, rtol=1e-5)


def test_unreachable_coordinator_raises():
    """Explicit arguments whose coordinator does not answer raise once
    the bring-up's timeout has passed; nothing is left up."""
    with pytest.raises(Exception, match="timed out|Timeout|timeout"):
        init_multihost(f"127.0.0.1:{free_port()}", 2, 1, device="cpu",
                       timeout_s=1)
    assert not torch.distributed.is_initialized()
    multihost.shutdown_multihost()


def test_two_gloo_ranks_equal_one_process(tmp_path):
    """Two processes on gloo, each running its own entries: the dp
    gather through all_gather_object, the sharded sweep's counts through
    all_reduce and a dp x sp batch split over the two processes equal
    the one-process results; mesh_info sees two processes with dp
    crossing them. A stuck rank fails the test at its timeout."""
    from ziria_tpu_torch.parallel import batch, stream_parallel_batched
    from ziria_tpu_torch.phy import link

    script = tmp_path / "rank.py"
    script.write_text(RANK)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(r),
         str(tmp_path / f"r{r}.npz")], env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    x = np.arange(4 * 32, dtype=np.float32).reshape(4, 32)
    psdus = np.random.default_rng(9).integers(0, 256, (4, 30)) \
        .astype(np.uint8)
    counts = link.sweep_ber(psdus, [6, 54], [0.0, 6.0], [0, 1],
                            device="cpu")
    prog = z.pipe(z.zmap(lambda v: v * 2 + 1, name="aff"),
                  z.map_accum(lambda s, v: (s + 1, v + s), 3, name="ctr",
                              advance=lambda s, n: s + n))
    frames = np.arange(4 * 133, dtype=np.int32).reshape(4, 133) % 97
    ys = stream_parallel_batched(prog, frames, build_mesh(
        dp=2, pp=4, axis_names=("dp", "sp"), device="cpu"))
    gathered = batch.data_parallel(lambda a: (a * 2).sum(-1),
                                   batch.frame_mesh(2, device="cpu"))(x)
    for r in (0, 1):
        got = np.load(tmp_path / f"r{r}.npz")
        np.testing.assert_array_equal(got["gathered"], gathered.numpy())
        np.testing.assert_array_equal(got["counts"], counts)
        np.testing.assert_array_equal(got["ys"], ys)
        assert int(got["n_processes"]) == 2 and str(got["dcn"]) == "dp"
