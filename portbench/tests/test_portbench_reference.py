"""The plain reference against the port's CPU path at a small size: the
normalized adjacency and the hops entry by entry, and each cell's whole run
(the program's timed entry, then the reference) coming out correct."""

import numpy as np
import pytest
import torch

from portbench import graphs, manifest
from portbench.programs.common import port_dataset
from portbench.reference import common, gamlp
from portbench.tests import small


@pytest.fixture(scope="module")
def data():
    cfg = small.config("gamlp-arxiv-train")
    return cfg, graphs.make_graph(cfg["dataset"], cfg["graph"], 2**31 + 3, "cpu")


def test_sym_norm_matches_the_port(data):
    from ssrg_torch.ops.normalize import sym_norm

    cfg, d = data
    port = sym_norm(port_dataset(d).adj, 0.5).tocsr()
    port.sort_indices()
    ref = common.sym_norm(d.num_nodes, d.lo, d.hi)
    assert np.array_equal(port.indptr, ref.crow_indices().numpy())
    assert np.array_equal(port.indices, ref.col_indices().numpy())
    np.testing.assert_array_equal(port.data, ref.values().numpy())
    t = common.transpose(ref)
    assert torch.equal(t.to_dense(), ref.to_dense().T)


def test_hops_match_the_port(data):
    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.ops.propagate import propagate
    from ssrg_torch.ops.sparse import device_adjacency

    cfg, d = data
    adj = device_adjacency(sym_norm(port_dataset(d).adj, 0.5), "auto", device="cpu")
    assert type(adj).__name__ == "HybridAdj"
    port = propagate(adj, d.x, 3, device="cpu")
    ref = gamlp.hops(d, cfg)
    assert common.relative_gap(port, ref) < 1e-6


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-12, 3.0e-3])
    r = common.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10
    assert r[2] == 1.0                     # a tie goes to the even neighbour
    assert r[3] == 1.0 + 2**-9             # so does this one, upwards
    assert r[4] == -1.0
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("workload", [w["name"] for w in manifest.load()["workloads"]]
                         + small.planned())
def test_each_cell_runs_correct_on_the_cpu(workload, tmp_path):
    _cell, outcome = small.execute(workload, root=small.with_planned(tmp_path))
    assert outcome.attempted >= 1 and outcome.failed == 0
    assert outcome.correct, [(c.name, c.value, c.limit) for c in outcome.checks]
    assert all(c.value < 1e-5 for c in outcome.checks)
    assert outcome.metrics["setup_s"] > 0
