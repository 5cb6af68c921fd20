"""The port's multi-device dry run (``deeprank2_tpu_torch/tools/dryrun_multichip.py``,
the counterpart of the JAX package's ``__graft_entry__.py:dryrun_multichip``)
over two gloo ranks on the CPU: every path's loss is finite and its
predictions agree with the same model on one rank within the JAX dry run's
1e-4; the summary and the four ``comm[...]`` lines come out in the JAX dry
run's form. One spawn serves every case."""

from __future__ import annotations

import math

import pytest

from deeprank2_tpu_torch.tools import dryrun_multichip as dm


@pytest.fixture(scope="module")
def report() -> dict:
    return dm.run(2, "gloo", "cpu", timeout=120, deadline=240)


@pytest.mark.parametrize("path", [*dm.DP_PATHS, *dm.FORWARD_PATHS])
def test_every_path_matches_one_rank(report, path) -> None:
    got = report["paths"][path]
    assert got["max_err"] < 1e-4
    if path in dm.DP_PATHS:
        assert math.isfinite(got["loss"])
        assert got["comm"]["all-reduce"]["count"] == 1 and got["comm"]["all-gather"]["count"] == 1


def test_summary_and_comm_lines(report) -> None:
    ok, lines = dm.summary(report, 1e-4)
    assert ok and lines[0].startswith("dryrun_multichip OK on 2 ranks (gloo, cpu); dp loss=")
    assert lines[1:] == [
        "comm[dp_dense_train @ 2]: " + lines[1].split(": ", 1)[1],
        "comm[edge_partition_fwd @ 2]: all-reduce: 1x 1.0kB, all-gather: 4x 98.3kB",
        "comm[ring_halo_fwd @ 2]: all-reduce: 1x 1.0kB, collective-permute: 4x 49.2kB",
        "comm[blocksparse_ring_fwd @ 2]: all-reduce: 1x 0.5kB, collective-permute: 2x 147.5kB",
    ]
    assert "all-reduce: 1x" in lines[1] and "all-gather: 1x" in lines[1]
    assert not dm.summary({**report, "paths": {**report["paths"], "ring_halo": {"max_err": 1.0}}}, 1e-4)[0]
