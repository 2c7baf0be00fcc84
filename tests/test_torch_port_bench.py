"""The port's bench entry point (``ssrg_torch.bench``) against
``ssrg_tpu.bench``, on the CPU at small sizes, plus one ``cuda``-marked run
on the card.

The parity tests import ``ssrg_tpu`` inside the test, so that the file
imports no jax and its ``cuda`` test runs on the card with
``python -m pytest tests/test_torch_port_bench.py -m cuda --noconftest``."""

import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ssrg_torch import bench

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(num_nodes=1500, avg_degree=6.0, num_features=16, prop_steps=2)


@pytest.mark.parametrize("kind", ["uniform", "powerlaw"])
def test_make_benchmark_graph_matches_reference(kind):
    from ssrg_tpu.bench import make_benchmark_graph as ref_make

    adj, x = bench.make_benchmark_graph(3000, 9.0, 8, seed=2, kind=kind)
    ref_adj, ref_x = ref_make(3000, 9.0, 8, seed=2, kind=kind)
    ref_adj = ref_adj.tocsr()
    ref_adj.sort_indices()
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(adj, name), getattr(ref_adj, name))
    np.testing.assert_array_equal(x, ref_x)


def test_run_bench_on_the_cpu(capsys):
    """The port's counterpart of ``tests/test_cli.py::test_cli_bench_tiny``."""
    result = bench.run_bench(**SMALL, device="cpu")
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload == json.loads(json.dumps(result))
    assert payload["metric"] == "khop_spmm_edges_per_s" and payload["unit"] == "edges/s"
    assert payload["value"] > 0 and payload["nnz"] > 0
    # dense engine at this size: the gather engines' traffic model stays out
    assert "hbm_frac" not in payload and "achieved_gbps" not in payload
    assert "mxu_frac" not in payload
    assert not [k for k in payload if k.endswith("_error")]
    for key in ("value", "library_edges_per_s", "baseline_edges_per_s",
                "sharded_edges_per_s", "sharded_vs_bare", "clustered_edges_per_s",
                "banded_pallas_edges_per_s"):
        assert math.isfinite(payload[key]) and payload[key] > 0, key
    assert payload["sharded_vs_bare"] == payload["sharded_edges_per_s"] / payload["value"]
    assert payload["baseline"] == "scipy_csr" and payload["device"] == "cpu"
    assert payload["clustered_num_nodes"] == 1500
    for key in ("headline_spread", "sharded_spread", "clustered_spread",
                "banded_pallas_spread"):
        assert 0 <= payload[key] < 1


def test_gather_engine_reports_its_traffic_model():
    diag = {}
    adj, x = bench.make_benchmark_graph(9000, 6.0, 8)
    rate = bench.device_edges_per_s(adj, x, 2, engine="auto", iters=1, diag=diag,
                                    device="cpu")
    assert rate > 0 and diag["achieved_gbps"] > 0 and diag["achieved_gflops"] > 0
    assert "hbm_frac" not in diag                     # no H100 here


def test_clustered_tiled_fraction_matches_reference():
    from ssrg_tpu.bench import fast_tier_metrics as ref_fast

    ref = ref_fast(num_nodes=8000, num_features=8, prop_steps=1, iters=1)
    assert "clustered_error" not in ref
    got = bench.fast_tier_metrics(num_nodes=8000, num_features=8, prop_steps=1, iters=1,
                                  device="cpu")
    assert 0 < got["clustered_tiled_fraction"] < 1
    assert round(got["clustered_tiled_fraction"], 4) == ref["clustered_tiled_fraction"]
    assert got["clustered_num_nodes"] == ref["clustered_num_nodes"]


def test_banded_tier_inputs_are_a_seeded_dense_band():
    from ssrg_torch.ops.pallas_banded import PallasBandedAdj

    blocks, los, x = bench.banded_tier_inputs(8, device="cpu")
    for a, b in zip((blocks, los, x), bench.banded_tier_inputs(8, device="cpu")):
        assert torch.equal(a, b)
    nb, rb, w = blocks.shape
    n = nb * rb
    assert (nb, rb, w) == (2, 512, 1024) and blocks.dtype == torch.bfloat16
    assert bool((blocks != 0).all())                  # every entry is a product to do
    assert x.shape == (n, 8) and bool((los % 16 == 0).all())
    assert int(los.min()) >= 0 and int(los.max()) + w <= n
    # one hop of the tier (the plain version on the CPU) against the dense
    # product in float64 of the same blocks and the bf16-rounded x; each
    # output is an f32 sum of w products, within w * 2^-24 * sum|a * x|
    dense = np.zeros((n, n))
    for b in range(nb):
        lo = int(los[b])
        dense[b * rb:(b + 1) * rb, lo:lo + w] = blocks[b].float().numpy()
    xr = x.bfloat16().double().numpy()
    got = PallasBandedAdj(blocks, los, n, n, rb, window_bf16=True).spmm(x).numpy()
    tol = w * 2.0 ** -24 * (np.abs(dense) @ np.abs(xr))
    assert np.all(np.abs(got - dense @ xr) <= tol)


def test_reference_kernel_is_used_only_when_named(monkeypatch, tmp_path):
    adj, _ = bench.make_benchmark_graph(300, 4.0, 4)
    monkeypatch.delenv(bench.REFERENCE_SO_ENV, raising=False)
    assert bench._reference_kernel(adj) is None
    assert bench._reference_kernel(adj, str(tmp_path / "libmatmul.so")) is None
    broken = tmp_path / "broken.so"
    broken.write_bytes(b"not a library")
    monkeypatch.setenv(bench.REFERENCE_SO_ENV, str(broken))
    with pytest.raises(OSError):
        bench._reference_kernel(adj)


def test_sharded_tier_is_not_ported():
    """The sharded tier runs the distributed hybrid engine on a world of one
    gloo rank it starts and ends, and counts the reference's keys."""
    from ssrg_tpu.bench import sharded_tier_metrics as ref_sharded

    adj, _ = bench.make_benchmark_graph(9000, 6.0, 8)
    assert not dist.is_initialized()
    got = bench.sharded_tier_metrics(adj, 8, 2, iters=1, device="cpu")
    assert not dist.is_initialized()
    want = ref_sharded(adj, 8, 2, iters=1)
    assert set(got) == set(want) == {"sharded_edges_per_s", "sharded_spread"}
    assert math.isfinite(got["sharded_edges_per_s"]) and got["sharded_edges_per_s"] > 0
    assert 0 <= got["sharded_spread"] < 1


@pytest.mark.parametrize("target", [
    "ssrg_torch.ops.sparse.device_adjacency",          # the headline
    "ssrg_torch.ops.sparse.build_tiled",               # the clustered tier
    "ssrg_torch.ops.pallas_banded.PallasBandedAdj",    # the banded tier
    "ssrg_torch.parallel.dist_spmm.shard_adjacency_hybrid",  # the sharded tier
])
def test_a_failing_tier_fails_the_run(target, monkeypatch, capsys):
    def broken(*args, **kwargs):
        raise ValueError(f"broken {target}")

    monkeypatch.setattr(target, broken)
    with pytest.raises(ValueError, match="broken"):
        bench.run_bench(**SMALL, iters=2, device="cpu")
    assert capsys.readouterr().out == ""
    if dist.is_initialized():   # the sharded tier's world of one, left by its failure
        dist.destroy_process_group()


def test_bench_module_prints_one_json_line():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "ssrg_torch.bench", "--device", "cpu", "--nodes", "1500",
         "--degree", "6", "--features", "16", "--prop_steps", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    payload = json.loads(lines[0])
    assert payload["metric"] == "khop_spmm_edges_per_s" and payload["value"] > 0
    assert payload["num_nodes"] == 1500 and payload["prop_steps"] == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_run_bench_on_the_card(cuda_device, tmp_path):
    from ssrg_torch.ops.banded_spmm import banded_spmm
    from ssrg_torch.ops.ell_spmm import ell_spmm
    from ssrg_torch.ops.rest_spmm import rest_spmm

    for fn in (ell_spmm, banded_spmm, rest_spmm):
        fn.launches = 0
    result = bench.run_bench(num_nodes=20_000, avg_degree=6.0, num_features=32,
                             prop_steps=2, iters=2, emit=False,
                             trace_dir=str(tmp_path / "trace"))
    for key in ("value", "library_edges_per_s", "clustered_edges_per_s",
                "banded_pallas_edges_per_s", "achieved_gbps"):
        assert math.isfinite(result[key]) and result[key] > 0, key
    assert result["device"] == "cuda"
    assert (tmp_path / "trace" / "trace.json").exists()
    assert result["trace"]["device_events"] > 0 and 0 < result["trace"]["busy_share"] <= 1
    assert ell_spmm.launches > 0 and banded_spmm.launches > 0 and rest_spmm.launches > 0
