"""The port's packet search (ziria_tpu_torch/phy/search.py) against the
JAX package on the CPU: the detection metric and the packet starts of
tests/test_search.py's captures equal the reference's (metric within
2e-6: the same float32 sums in another order; starts exact), a noise
capture finds nothing, the metric split over an sp mesh equals the
reference's sharded one (within 2e-4; starts exact), and one
scan_and_decode through the CLI's --scan returns what the reference's
scan_and_decode returns: every packet's PSDU, at the same starts."""

import numpy as np
import pytest

from test_search import _capture_with_frames
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.phy import search as jax_search
from ziria_tpu_torch.phy import search


def test_metric_and_starts_equal_the_references():
    for offsets, n in (([1000, 5000, 9000], 12000),
                       ([700, 4200, 7900, 11500], 8 * 1750 + 9)):
        cap = _capture_with_frames(offsets, n)
        m = search.detection_metric(cap, device="cpu")
        want = jax_search.detection_metric(cap)
        assert m.shape == want.shape
        np.testing.assert_allclose(m, want, rtol=2e-6, atol=2e-6)
        got = search.find_packets(cap, device="cpu")
        np.testing.assert_array_equal(got, jax_search.find_packets(cap))
        assert len(got) == len(offsets)
        for s, off in zip(got, offsets):
            assert off - 32 <= s <= off + 160
    rng = np.random.default_rng(5)
    noise = rng.normal(scale=0.05, size=(4000, 2)).astype(np.float32)
    assert search.find_packets(noise, device="cpu").size == 0


def test_mesh_names_item_5():
    """Item 5 ported the sp mesh: the metric split over 8 virtual CPU
    entries (halo exchange, zero pad and trim) is within the reference
    test's 2e-4 of the unsharded metric and of the reference's sharded
    one, and the starts are exact; shards shorter than the halo are
    refused with the reference's message; scan_and_decode takes the
    mesh."""
    from ziria_tpu.parallel.streampar import StreamParError as JErr, \
        stream_mesh as jstream_mesh
    from ziria_tpu_torch.parallel.streampar import StreamParError, \
        stream_mesh

    mesh, jmesh = stream_mesh(8, device="cpu"), jstream_mesh(8)
    for offsets, n in (([1000, 5000, 9000], 12000),
                       ([700, 4200, 7900, 11500], 8 * 1750 + 9)):
        cap = _capture_with_frames(offsets, n)
        m = search.detection_metric(cap, mesh=mesh, device="cpu")
        np.testing.assert_allclose(
            m, search.detection_metric(cap, device="cpu"),
            rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(
            m, jax_search.detection_metric(cap, mesh=jmesh),
            rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(
            search.find_packets(cap, mesh=mesh, device="cpu"),
            jax_search.find_packets(cap, mesh=jmesh))
    short = np.random.default_rng(4).normal(size=(400, 2)) \
        .astype(np.float32)
    with pytest.raises(StreamParError) as e:
        search.detection_metric(short, mesh=mesh, device="cpu")
    with pytest.raises(JErr) as je:
        jax_search.detection_metric(short, mesh=jmesh)
    assert str(e.value) == str(je.value)
    noise = np.round(np.random.default_rng(6).normal(
        scale=20.0, size=(4000, 2))).astype(np.int16)
    assert search.scan_and_decode(noise, mesh=mesh, device="cpu") == []


def test_cli_scan_decodes_every_packet(tmp_path):
    """Three packets (12, 24 and 6 Mbit/s) in 900-sample noise gaps, the
    reference test's recipe: --scan writes their PSDUs back to back,
    the reference's scan_and_decode's packets, at its starts."""
    from ziria_tpu.phy import channel as jax_channel
    from ziria_tpu_torch.runtime import cli
    from ziria_tpu_torch.runtime.buffers import (StreamSpec, read_stream,
                                                 write_stream)

    rng = np.random.default_rng(3)
    parts, psdus = [], []

    def gap(n):
        return np.clip(np.round(rng.normal(scale=20.0, size=(n, 2))),
                       -32768, 32767).astype(np.int16)

    parts.append(gap(900))
    for k, (mbps, nb) in enumerate([(12, 40), (24, 60), (6, 30)]):
        psdu, xi = jax_channel.impaired_capture(
            mbps, nb, seed=700 + k, cfo=0.001, pre=0, post=0, noise=0.02,
            add_fcs=True)
        psdus.append(np.asarray(psdu))
        parts += [np.asarray(xi), gap(900)]
    capture = np.concatenate(parts, axis=0)
    inf, outf = tmp_path / "cap.bin", tmp_path / "pay.bin"
    write_stream(StreamSpec(ty="complex16", path=str(inf), mode="bin"),
                 capture)
    assert cli.main(["--scan", "--platform=cpu", f"--input-file-name={inf}",
                     "--input-file-mode=bin", f"--output-file-name={outf}",
                     "--output-file-mode=bin"]) == 0
    ref = jax_search.scan_and_decode(capture)
    assert cli.LAST_RUN["packets"] == [s for s, _bits in ref]
    got = read_stream(StreamSpec(ty="bit", path=str(outf), mode="bin"))
    want = np.concatenate([np.unpackbits(p, bitorder="little")
                           for p in psdus])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.concatenate(
        [np.asarray(bits, np.uint8) for _s, bits in ref]))
    with pytest.raises(SystemExit, match="drop --src/--prog"):
        cli.main(["--scan", "--src=x.zir", "--platform=cpu"])
