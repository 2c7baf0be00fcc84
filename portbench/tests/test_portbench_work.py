"""``work.py``'s counts against counts made by hand on small shapes."""

import pytest
import torch

from portbench import graphs, work
from portbench.programs import gamlp, gcn
from portbench.tests import small


def test_gemm_spmm_elementwise_by_hand():
    w = work.Work()
    work.gemm(w, "g", 2, 3, 4)
    assert w.flops == 2 * 2 * 3 * 4 and w.bytes == 4 * (6 + 12 + 8)
    w = work.Work()
    work.spmm(w, "s", nnz=10, rows=5, cols=6, features=3)
    assert w.flops == 2 * 10 * 3 and w.bytes == 4 * (20 + 18 + 15)
    w = work.Work()
    work.elementwise(w, "e", 7, 2)
    assert w.bytes == 4 * 14 and w.flops == 7
    w = work.Work()
    work.adam(w, 5)
    assert w.bytes == 4 * 35


def test_least_time_is_the_larger_bound():
    w = work.Work().add("flops", 67e12, 0.0)
    assert w.least_s == pytest.approx(1.0)
    w = work.Work().add("bytes", 0.0, 3.35e12)
    assert w.least_s == pytest.approx(1.0)
    w = work.Work().add("both", 67e12, 6.7e12)
    assert w.least_s == pytest.approx(2.0)


def data(workload):
    cfg = small.config(workload)
    return cfg, graphs.make_graph(cfg["dataset"], cfg["graph"], 3, "cpu")


def test_gcn_epoch_by_hand():
    cfg, d = data("gcn-products-fullbatch")
    n, nnz, f, h, c = d.num_nodes, d.nnz, 16, 32, cfg["dataset"]["num_classes"]
    w = gcn.epoch_work(cfg, d)
    spmm = [p for p in w.parts if p[0].startswith("spmm")]
    assert len(spmm) == 9
    assert sum(p[1] for p in spmm) == 2 * nnz * (3 * (h + h + c))
    gemm_flops = sum(p[1] for p in w.parts if p[0].startswith("lin"))
    # forward and evaluation: each layer once; backward: dW of each, dX of all but the first
    assert gemm_flops == 2 * n * (2 * (f * h + h * h + h * c) + (f * h + h * h + h * c)
                                  + (h * h + h * c))
    assert gcn.spmm_features(cfg) == [h, h, c, c, h, h, h, h, c]


def test_ell_edges_cap_each_row_at_the_width():
    cfg, d = data("gcn-products-fullbatch")
    deg = d.degrees() + 1
    assert gcn.ell_edges(d, 10 ** 9) == d.nnz
    assert gcn.ell_edges(d, 1) == d.num_nodes
    assert gcn.ell_edges(d, 8) == int(torch.clamp(deg, max=8).sum())


def test_gamlp_epoch_by_hand():
    cfg, d = data("gamlp-arxiv-train")
    f, h, c, k = 16, 32, cfg["dataset"]["num_classes"], 4
    n_tr, n_va, n_te = (int(i.numel()) for i in (d.train_idx, d.val_idx, d.test_idx))
    w = gamlp.epoch_work(cfg, d)
    head = 2 * (f * h + h * h + h * c)
    flops = sum(p[1] for p in w.parts if p[0].startswith("fc"))
    assert flops == head * (n_tr + n_va + n_te) + 2 * head * n_tr
    jk = sum(p[1] for p in w.parts if p[0].startswith("jk"))
    assert jk == 2 * k * (k + 1) * f * (2 * n_tr + n_va + n_te)
