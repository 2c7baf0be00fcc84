#!/usr/bin/env python3
"""Hold the port's CUDA kernels to their plain versions on one NVIDIA GPU,
and time them and variants of their constants.

    python3 tools/kernels.py [--kernel ell,coo,banded,rest,gat]
                             [--variants NAME,NAME,...] [--seed N]
                             [--parts attention,scores,edges]

Each entry of ``KERNELS`` names a kernel's wrapper module, its variants
(``constexpr int`` constants of its source set to other values) and its
cases. The source and each chosen variant are built at once into
``ssrg_torch/build/variants/<kernel>/`` (each build's ``ptxas`` lines are
printed). On each case, every step of the kernel runs through its wrapper
with each variant's library: held to its plain version within the kernel's
sum-order tolerance (``tools/card.py``), then timed by CUDA events in turns
(after a round that only warms the card, the variants in order in one round,
in reverse in the next; the median of the rounds), beside its plain version,
a library call where one does the same work, and its bound: the compulsory
bytes over 3.35 TB/s or the multiply-adds at the peak rate of their type,
whichever is longer.

One JSON line a case and step: the source's ``ms``, ``bound_share`` and
``gb_per_s`` (compulsory bytes over its time), ``gather_gb_per_s`` where the
kernel gathers rows, ``bound_ms``, ``plain_ms``, ``library_ms``, and by
variant ``ms_by_variant``, ``bound_share_by_variant``, ``max_abs_err`` and
``max_err_over_tolerance``; then the card's name and power limit.

The cases, on the 169,343-node graphs of ``tools/card.py`` unless said:
``ell`` the headline and power-law hybrid packs at F = 128, the headline
pack folded onto an x of ``L2_ROWS`` rows (x stays in L2), and the pack the
backward runs on (A^T) of the symmetric and the r = 0.3 normalization of
``TRAIN_GRAPH`` at F = 256 and 40; ``coo`` the headline and power-law tails
at F = 128 and the ``gcn-products-fullbatch`` cell's tail (drawn from
``--seed`` as ``portbench/`` draws it) at the epoch's F = 256 and 47;
``banded`` the ``reorder_banded`` f32 pack (stream path) and bf16 pack
(tensor cores) at F = 128, the bf16 pack at F = 256 and the bench's dense
bf16 pack; ``rest`` the ``reorder_tiled`` community rest, bf16 and f32
gathers; ``gat`` with ``--parts attention`` the four attention steps
(``stats``, ``aggregate``, ``rowdot``, ``backward``) on the power-law
graph's attention listing and the ``gat-products-fullbatch`` cell's, with
``--parts scores`` the score steps (``scores``, ``score_grad``) on a z of
each graph's rows, all at the cell's head widths, 4 heads of 128 and 4 of
47, and with ``--parts edges`` the graph-transformer attention's steps
(``sddmm``, ``edge_stats``, ``edge_aggregate``, ``rowdot``,
``edge_backward``, ``weighted_sum_dq``, ``weighted_sum_dk``) on the
``unimp-products-fullbatch`` cell's listing, no self-loops, its weights
dropped at 0.3, with ``torch.sparse.sampled_addmm`` as the scores' library
call. At 4 heads of 47 the source's weighted sum and backward pass take the
whole-row path and the ``per_head`` variant the per-head scalar lanes. The
``aggregate`` records also time the aggregation on the ELL and COO kernels,
alpha as their values, one head at a time (``reuse_hybrid_kernels``).

The wrappers launch the source's own constants; this script only measures
that choice. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
from typing import Callable, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, tools/ comes first on the path: the checkout's root takes
# its place and tools/ goes last, so that no file here shadows another
# top-level name
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
sys.path.append(HERE)

import card  # noqa: E402  (tools/card.py)

GAT_SHAPES = ((4, 128), (4, 47))  # (heads, head width): the GAT cell's hidden layers, its last
GAT_SLOPE = 0.2
CELL_GCN = os.path.join(ROOT, "portbench", "configs", "gcn-products.json")
CELL_GAT = os.path.join(ROOT, "portbench", "configs", "gat-products.json")
CELL_UNIMP = os.path.join(ROOT, "portbench", "configs", "unimp-products.json")


@dataclasses.dataclass
class Step:
    """One call of a kernel on a case."""

    name: str
    run: Callable              # the kernel through its wrapper
    plain: Callable            # its plain version on the same inputs
    reference: Callable        # () -> (outputs, tolerances) the kernel's outputs are held to
    nbytes: int                # compulsory bytes: every operand and result moved once
    flops: float
    peak: float = card.F32_FLOPS_PER_S
    gathers: int = 0           # bytes of the rows the kernel gathers, one per entry
    library: Optional[Callable] = None
    info: dict = dataclasses.field(default_factory=dict)
    held: Optional[Callable] = None  # the kernel as held, where run adds into its output


@dataclasses.dataclass
class Kernel:
    module: str                # ssrg_torch.ops.<module>: NAME, _declare and the wrappers
    variants: tuple            # (name, {constant: value}), the source's first
    cases: Callable            # (args) -> iterator of (case name, [Step])
    rounds: int = 4
    plain_timing: dict = dataclasses.field(default_factory=lambda: {"iters": 5, "warmup": 1})


def csr_of(rows, cols, vals, shape):
    """A torch CSR tensor of entries listed by row."""
    import torch

    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=cols.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=shape[0]), 0)
    return torch.sparse_csr_tensor(crow, cols.long(), vals, size=shape)


def headline_and_powerlaw():
    """The headline (uniform) and power-law graphs' hybrid packs of
    ``D^-1/2 A D^-1/2`` and their features, on the card, by name."""
    import torch

    from ssrg_torch.data.synthetic import powerlaw_graph, random_graph
    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.ops.sparse import build_hybrid

    graphs = {"headline": random_graph(card.NUM_NODES, card.AVG_DEGREE, card.NUM_FEATURES,
                                       num_classes=card.NUM_CLASSES, seed=card.SEED),
              "powerlaw": powerlaw_graph(card.NUM_NODES, card.AVG_DEGREE, card.NUM_FEATURES,
                                         seed=card.SEED)}
    for name, g in graphs.items():
        yield name, build_hybrid(sym_norm(g.adj, 0.5)).to("cuda"), torch.as_tensor(g.x,
                                                                                  device="cuda")


def cell_pairs(config: str, seed: int, self_loops: bool = True):
    """The cell's ``A + I`` (``A`` without ``self_loops``) on the card as
    ``portbench/`` draws it from ``seed``: rows and columns sorted by row,
    and the node count."""
    import torch

    from portbench.graphs import make_graph

    with open(config) as f:
        cfg = json.load(f)
    data = make_graph(cfg["dataset"], cfg["graph"], seed, "cuda")
    n = data.num_nodes
    loops = torch.arange(n if self_loops else 0, device="cuda")
    key = torch.sort(torch.cat([data.lo * n + data.hi, data.hi * n + data.lo,
                                loops * n + loops])).values
    del data, loops
    rows, cols = key // n, key % n
    del key
    torch.cuda.empty_cache()
    return rows, cols, n


# --- ELL ------------------------------------------------------------------------


def ell_step(cols, vals, x) -> Step:
    import torch

    from ssrg_torch.ops.ell_spmm import ell_spmm, ell_spmm_plain

    real = vals != 0
    counts = real.sum(dim=1)
    csr = csr_of(torch.repeat_interleave(torch.arange(cols.shape[0], device=x.device), counts),
                 cols[real], vals[real], (cols.shape[0], x.shape[0]))
    f = x.shape[1]
    return Step(
        "spmm", lambda: ell_spmm(cols, vals, x), lambda: ell_spmm_plain(cols, vals, x),
        lambda: (ell_spmm_plain(cols, vals, x), card.ell_tolerance(cols, vals, x)),
        # the pack, x and out once; a multiply-add per F for each real slot
        nbytes=(cols.numel() + vals.numel() + x.numel() + cols.shape[0] * f) * 4,
        flops=2.0 * int(counts.sum()) * f, gathers=int(counts.sum()) * f * 4,
        library=lambda: torch.sparse.mm(csr, x),
        info={"rows": int(cols.shape[0]), "width": int(cols.shape[1]), "n": int(x.shape[0]),
              "f": f, "real_slots": int(counts.sum()), "slots": int(cols.numel())})


def ell_cases(args):
    import torch

    from ssrg_torch.data.synthetic import planetoid_like
    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.ops.sparse import differentiable_adjacency

    for name, hyb, x in headline_and_powerlaw():
        yield name, [ell_step(hyb.ell.cols, hyb.ell.vals, x)]
        if name == "headline":
            folded = torch.remainder(hyb.ell.cols, card.L2_ROWS)
            yield "headline_l2_resident", [ell_step(folded, hyb.ell.vals, x[:card.L2_ROWS])]
        del hyb, x
    ds = planetoid_like(**card.TRAIN_GRAPH)
    gen = torch.Generator(device="cuda").manual_seed(card.SEED)
    for name, r in (("symmetric", 0.5), ("r0.3", 0.3)):
        bwd = differentiable_adjacency(sym_norm(ds.adj, r), "hybrid", device="cuda").bwd
        for f in (256, 40):
            g = torch.randn((card.NUM_NODES, f), generator=gen, device="cuda")
            yield f"train_{name}_bwd_f{f}", [ell_step(bwd.ell.cols, bwd.ell.vals, g)]
        del bwd
        torch.cuda.empty_cache()


# --- COO ------------------------------------------------------------------------


def coo_step(row, col, val, x, nnz: int, out0) -> Step:
    """The held call adds into a copy of ``out0``; the timed one into one
    copy again and again."""
    import torch

    from ssrg_torch.ops.coo_spmm import coo_accumulate, coo_accumulate_plain

    f, n_rows = x.shape[1], out0.shape[0]
    out = out0.clone()
    x_rows = int(torch.unique(col[:nnz]).numel())
    out_rows = int(torch.unique(row[:nnz]).numel())
    csr = csr_of(row[:nnz].long(), col[:nnz], val[:nnz], (n_rows, x.shape[0]))
    return Step(
        f"tail_f{f}", lambda: coo_accumulate(row, col, val, x, out, nnz),
        lambda: coo_accumulate_plain(row, col, val, x, out, nnz),
        lambda: (coo_accumulate_plain(row, col, val, x, out0.clone(), nnz),
                 card.coo_tolerance(row, col, val, x, out0, nnz)),
        # the entries (row, column, value), every x row and out row they touch, once
        nbytes=nnz * 12 + (x_rows + out_rows) * f * 4, flops=2.0 * nnz * f,
        gathers=nnz * f * 4, library=lambda: torch.sparse.mm(csr, x),
        held=lambda: coo_accumulate(row, col, val, x, out0.clone(), nnz),
        info={"entries": nnz, "f": f, "n": n_rows, "x_rows": x_rows, "out_rows": out_rows,
              "library": "torch.sparse.mm on the CSR of the same entries (no add into out)"})


def coo_cases(args):
    import numpy as np
    import scipy.sparse as sp
    import torch

    from ssrg_torch.ops.sparse import build_hybrid

    for name, hyb, x in headline_and_powerlaw():
        t = hyb.tail
        entries = t.nnz_padded if t.nnz is None else t.nnz
        if entries:
            yield f"{name}_tail", [coo_step(t.row, t.col, t.val, x, entries, torch.zeros(
                (t.n_rows, x.shape[1]), device="cuda"))]
        del hyb, x
    rows, cols, n = cell_pairs(CELL_GCN, args.seed)
    deg = torch.bincount(rows, minlength=n)
    dinv = deg.double().rsqrt()
    vals = (dinv[rows] * dinv[cols]).float()
    indptr = np.concatenate([[0], torch.cumsum(deg, 0).cpu().numpy()])
    csr = sp.csr_matrix((vals.cpu().numpy(), cols.int().cpu().numpy(), indptr), shape=(n, n))
    del rows, cols, vals, deg, dinv
    torch.cuda.empty_cache()
    pack = build_hybrid(csr)
    t = pack.tail.to("cuda")
    card.emit({"phase": "pack", "kernel": "coo", "seed": args.seed, "n": n, "nnz": int(csr.nnz),
               "ell_width": pack.ell.width, "tail_entries": t.nnz,
               "tail_share": t.nnz / int(csr.nnz)})
    del pack, csr
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for f in (256, 47):  # the GCN epoch's widths: hidden (float4 lanes), classes (scalar)
        x = torch.randn((n, f), generator=gen, device="cuda")
        yield f"gcn_cell_tail_f{f}", [coo_step(t.row, t.col, t.val, x, t.nnz, torch.randn(
            (n, f), generator=gen, device="cuda"))]
        del x
        torch.cuda.empty_cache()


# --- banded and rest: the locality tier's packs ---------------------------------------


def banded_step(blocks, los, x, round_x: bool) -> Step:
    import torch

    from ssrg_torch.ops.banded_spmm import banded_spmm, banded_spmm_plain, path

    nb, rb, w = blocks.shape
    f = x.shape[1]
    bf16 = blocks.dtype == torch.bfloat16
    nonzeros = int((blocks != 0).sum())
    # the yardstick: one torch.bmm of the blocks with their windows, gathered
    # beforehand (the gather is not in its time)
    xp = torch.cat([x, x.new_zeros((max(int(los.max()) + w - x.shape[0], 0), f))])
    windows = xp[los.long()[:, None] + torch.arange(w, device=x.device)]
    del xp
    windows = windows.bfloat16() if bf16 else (windows.bfloat16().float() if round_x else windows)
    return Step(
        "spmm", lambda: banded_spmm(blocks, los, x, round_x),
        lambda: banded_spmm_plain(blocks, los, x, round_x),
        lambda: (banded_spmm_plain(blocks, los, x, round_x),
                 card.banded_tolerance(blocks, los, x, round_x)),
        # the blocks, los, x and out once; a multiply-add a feature for each
        # nonzero entry at the peak rate of the blocks' type
        nbytes=blocks.numel() * blocks.element_size() + los.numel() * 4 + (x.numel()
                                                                            + nb * rb * f) * 4,
        flops=2.0 * nonzeros * f, peak=card.BF16_FLOPS_PER_S if bf16 else card.F32_FLOPS_PER_S,
        library=lambda: torch.bmm(blocks, windows),
        info={"path": path(blocks), "blocks": [nb, rb, w], "n": int(x.shape[0]), "f": f,
              "nonzeros": nonzeros, "dense_tflops": 2.0 * nb * rb * w * f / 1e12,
              "library": f"torch.bmm in {blocks.dtype} over windows gathered beforehand"})


def banded_cases(args):
    import torch

    from ssrg_torch import bench

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = card.banded_dataset()
    for run, bf16 in (("banded_f32", False), ("banded_bf16", True)):
        pack, x = card.locality_pack(ds, "reorder_banded", bf16)
        yield f"{run}_pack", [banded_step(pack.blocks, pack.los, x, pack.window_bf16)]
        if bf16:
            gen = torch.Generator(device="cuda").manual_seed(card.SEED)
            x = torch.randn((x.shape[0], 256), generator=gen, device="cuda")
            yield f"{run}_pack_f256", [banded_step(pack.blocks, pack.los, x, True)]
        del pack, x
        torch.cuda.empty_cache()
    blocks, los, x = bench.banded_tier_inputs(card.NUM_FEATURES, "cuda")
    yield "bench_banded_dense", [banded_step(blocks, los, x, True)]


def rest_step(pack, x) -> Step:
    import torch

    from ssrg_torch.ops.rest_spmm import rest_spmm, rest_spmm_plain

    rp, re_, cols, vals, bf16 = pack.row_ptr, pack.row_end, pack.cols, pack.vals, pack.gather_bf16
    n_out, f = rp.shape[0] - 1, x.shape[1]
    counts = re_ - rp[:-1]
    end = int(rp[-1])
    row_of = torch.repeat_interleave(torch.arange(n_out, device=x.device), rp.diff(),
                                     output_size=end)
    real = torch.arange(end, device=x.device) < re_[row_of]
    csr = csr_of(row_of[real], cols.reshape(-1)[:end][real], vals.reshape(-1)[:end][real],
                 (n_out, x.shape[0]))
    n_real = int(counts.sum())
    return Step(
        "spmm", lambda: rest_spmm(rp, re_, cols, vals, x, bf16),
        lambda: rest_spmm_plain(rp, re_, cols, vals, x, bf16),
        lambda: (rest_spmm_plain(rp, re_, cols, vals, x, bf16),
                 card.rest_tolerance(rp, re_, cols, vals, x, bf16)),
        # the layout (cols, vals and one row boundary array, row_ptr), x and out
        # once; row_end is the kernel's own shortcut past the pads, not counted
        nbytes=rp.numel() * 8 + (cols.numel() + vals.numel() + x.numel() + n_out * f) * 4,
        flops=2.0 * n_real * f, gathers=n_real * f * 4, library=lambda: torch.sparse.mm(csr, x),
        info={"rows": n_out, "n": int(x.shape[0]), "f": f, "chunks": pack.num_chunks,
              "real_entries": n_real, "pad_entries": end - n_real, "gather_bf16": bool(bf16)})


def rest_cases(args):
    pack, x = card.locality_pack(card.community_dataset(), "reorder_tiled", True)
    for bf16 in (True, False):
        yield f"community_rest_{'bf16' if bf16 else 'f32'}", [
            rest_step(dataclasses.replace(pack.rest, gather_bf16=bf16), x)]


# --- GAT ---------------------------------------------------------------------------


def attention_steps(edges, h: int, c: int, gen) -> list:
    """The four attention steps on the listing ``edges`` at ``h`` heads of
    ``c``, random z, scores and gradients.

    Tolerances, elementwise, k a node's entries (the listing is symmetric)
    and T = 16 + 2 max|a - m| in units of u = 2^-24 for one alpha or
    exponent term (expf and the division, each path, and the exponent's
    argument rounded once more where nvcc fuses it): the row maxima exact;
    the sums ``(2k + T) u l``; the weighted sum ``(2k + T) u sum alpha
    |z|``; the row dot ``2 (c + 1) u sum |g out|`` (its packed values
    exact); dz ``(2k + T) u sum alpha |g|``; both scores' gradients ``(2 (c
    + k) + T + 6) u M``, M the sum of ``alpha (sum |g z| + |delta|)
    leaky'``, which the plain backward pass gives on the operands' absolute
    values."""
    import torch

    from ssrg_torch.ops import gat_attention as ga

    u, n, e, s = card.UNIT_ROUNDOFF, edges.num_nodes, edges.nnz, GAT_SLOPE
    row, col, t_row, t_col = edges.row, edges.col, edges.t_row, edges.t_col
    z, g = (torch.randn((n, h, c), generator=gen, device="cuda") for _ in range(2))
    s_src, s_dst = (torch.randn((n, h), generator=gen, device="cuda") for _ in range(2))
    k = torch.bincount(row.long(), minlength=n).float()[:, None]
    card.check(torch.equal(torch.bincount(t_row.long(), minlength=n).float()[:, None], k),
               "the attention listing is not symmetric: the tolerances take k for both ends")
    m, l = ga.softmax_stats_plain(row, col, s_src, s_dst, e, s)
    out = ga.aggregate_plain(row, col, s_src, s_dst, m, l, z, e, s)
    q = ga.rowdot_plain(g, out, s_dst, m, l)
    t = 16.0 + 2.0 * float(s_dst.abs().amax() + s_src.abs().amax() + m.abs().amax())

    def aggregate_ref():
        mag = ga.aggregate_plain(row, col, s_src, s_dst, m, l, z.abs(), e, s)
        return out, (2 * k[..., None] + t) * u * mag + 1e-30

    def rowdot_ref():
        tol = torch.full_like(q, 1e-30)
        tol[..., 3] += 2 * (c + 1) * u * (g * out).abs().sum(-1)
        return q, tol

    def backward_ref():
        q_abs = q.clone()
        q_abs[..., 3] = -q[..., 3].abs()
        mags = ga.backward_plain(t_row, t_col, q_abs, s_src, z.abs(), g.abs(), e, s)
        return (ga.backward_plain(t_row, t_col, q, s_src, z, g, e, s),
                tuple((f + t) * u * mag + 1e-30 for f, mag in zip(
                    (2 * k[..., None], 2 * (c + k) + 6, 2 * (c + k) + 6), mags)))

    f32, nh, nhc = 4, n * h, n * h * c
    info = {"nodes": n, "entries": e, "heads": h, "c": c, "max_row_entries": int(k.max()),
            "t": t}
    return [  # compulsory bytes: the listing, each [N, H] and [N, H, C] operand and result once
        Step("stats", lambda: ga.softmax_stats(row, col, s_src, s_dst, e, s),
             lambda: ga.softmax_stats_plain(row, col, s_src, s_dst, e, s),
             lambda: ((m, l), (torch.full_like(m, 1e-30), (2 * k + t) * u * l + 1e-30)),
             f32 * (4 * e + 7 * nh), 7.0 * e * h, info=info),
        Step("aggregate", lambda: ga.aggregate(row, col, s_src, s_dst, m, l, z, e, s),
             lambda: ga.aggregate_plain(row, col, s_src, s_dst, m, l, z, e, s), aggregate_ref,
             f32 * (2 * e + 2 * nhc + 4 * nh), 2.0 * e * h * c, gathers=e * h * c * 4,
             info={**info, "reuse_hybrid_kernels": reuse_design(row, col, n, s_src, s_dst, m,
                                                                l, z, out)}),
        Step("rowdot", lambda: ga.rowdot(g, out, s_dst, m, l),
             lambda: ga.rowdot_plain(g, out, s_dst, m, l), rowdot_ref,
             f32 * (2 * nhc + 7 * nh), 2.0 * nhc, info=info),
        Step("backward", lambda: ga.backward(t_row, t_col, q, s_src, z, g, e, s),
             lambda: ga.backward_plain(t_row, t_col, q, s_src, z, g, e, s), backward_ref,
             f32 * (2 * e + 3 * nhc + 7 * nh), 4.0 * e * h * c, gathers=e * h * c * 4,
             info=info),
    ]


def edge_steps(edges, h: int, c: int, rate: float, gen) -> list:
    """The graph-transformer attention's steps on the listing ``edges`` (no
    self-loops) at ``h`` heads of ``c``: the per-edge scores, their
    statistics, the weighted sum of v with the weights dropped at ``rate``
    (the UniMP cell's), the row dot, the backward pass (dv and the scores'
    gradient), and the weighted sums of the scores' gradient (dq over the
    rows, dk over the transposed listing at its places); random q, k, v, g.

    Tolerances, elementwise, k a node's entries (the listing is symmetric),
    u = 2^-24 and T = 16 + 2 max|s - m| as for GAT's steps: the scores ``2
    (c + 1) u scale sum |q k|``; the maxima exact; the sums ``(2k + T) u
    l``; the weighted sum ``(2k + T) u sum alpha~ |v|``; the row dot as
    GAT's; dv ``(2k + T) u sum alpha~ |g|``; the scores' gradient ``(2c + T
    + 6) u scale alpha (keep sum |g v| + |delta|)``; dq and dk ``(2k + 4) u
    sum |w| |row|``. The library's time is ``torch.sparse.sampled_addmm`` on
    the listing's CSR, a head at a time (one head's copies, called once a
    head), for the scores."""
    import torch

    from ssrg_torch.ops import gat_attention as ga

    u, n, e = card.UNIT_ROUNDOFF, edges.num_nodes, edges.nnz
    row, col, t_row, t_col = edges.row, edges.col, edges.t_row, edges.t_col
    pos = edges.positions()
    q, k, v, g = (torch.randn((n, h, c), generator=gen, device="cuda") for _ in range(4))
    scale, keep = 1.0 / c ** 0.5, 1.0 / (1.0 - rate)
    mask = torch.rand((h, e), generator=gen, device="cuda") < 1.0 - rate
    deg = torch.bincount(row.long(), minlength=n).float()[:, None]
    card.check(torch.equal(torch.bincount(t_row.long(), minlength=n).float()[:, None], deg),
               "the listing is not symmetric: the tolerances take k for both ends")
    s = ga.sddmm_plain(row, col, q, k, e, scale)
    m, l = ga.edge_stats_plain(row, s, n, e)
    out = ga.edge_aggregate_plain(row, col, s, m, l, v, e, mask, keep)
    q4 = ga.rowdot_plain(g, out, None, m, l)
    ds = ga.edge_backward_plain(t_row, t_col, pos, q4, s, v, g, e, mask, keep, scale)[1]
    finite_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    t = 16.0 + 2.0 * float((s.T - finite_m[row.long()]).abs().amax())

    # the tolerances are formed in place on the magnitudes: at the cell's size
    # each [N, H, C] operand is 4.9 GB
    def sddmm_ref():
        mag = ga.sddmm_plain(row, col, q.abs(), k.abs(), e, scale)
        return s, mag.mul_(2 * (c + 1) * u).add_(1e-30)

    def stats_ref():  # maxima of rows without entries (-inf) held as 0
        return (finite_m, l), (torch.full_like(m, 1e-30), (2 * deg + t) * u * l + 1e-30)

    def stats_held():
        mk, lk = ga.edge_stats(row, s, n, e)
        return torch.where(torch.isfinite(mk), mk, torch.zeros_like(mk)), lk

    def aggregate_ref():
        mag = ga.edge_aggregate_plain(row, col, s, m, l, v.abs(), e, mask, keep)
        return out, mag.mul_((2 * deg[..., None] + t) * u).add_(1e-30)

    def rowdot_ref():
        tol = torch.full_like(q4, 1e-30)
        tol[..., 3] += 2 * (c + 1) * u * (g * out).abs().sum(-1)
        return q4, tol

    def backward_ref():
        q4_abs = q4.clone()
        q4_abs[..., 3] = -q4[..., 3].abs()
        mag_dv, mag_ds = ga.edge_backward_plain(t_row, t_col, pos, q4_abs, s, v.abs(), g.abs(),
                                                e, mask, keep, scale)
        dv = ga.edge_backward_plain(t_row, t_col, pos, q4, s, v, g, e, mask, keep, scale)[0]
        return (dv, ds), (mag_dv.mul_((2 * deg[..., None] + t) * u).add_(1e-30),
                          mag_ds.abs_().mul_((2 * c + t + 6) * u).add_(1e-30))

    def sum_ref(rows, cols, z, places):
        def ref():
            want = ga.weighted_sum_plain(rows, cols, ds, z, e, places)
            mag = ga.weighted_sum_plain(rows, cols, ds.abs(), z.abs(), e, places)
            return want, mag.mul_((2 * deg[..., None] + 4) * u).add_(1e-30)
        return ref

    crow = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(row.long(), minlength=n), 0)
    template = torch.sparse_csr_tensor(crow, col.long(), torch.zeros(e, device="cuda"), (n, n))
    # one head's copies, its call made once a head: every head is the same work
    q_head, k_head = q[:, 0].contiguous(), k[:, 0].t().contiguous()

    def library():
        return [torch.sparse.sampled_addmm(template, q_head, k_head, beta=0.0, alpha=scale)
                for _ in range(h)]

    f32, nh, nhc, eh = 4, n * h, n * h * c, e * h
    info = {"nodes": n, "entries": e, "heads": h, "c": c, "max_row_entries": int(deg.max()),
            "t": t, "attn_dropout": rate}
    return [  # compulsory bytes: the listings, each operand and result once
        Step("sddmm", lambda: ga.edge_sddmm(row, col, q, k, e, scale),
             lambda: ga.sddmm_plain(row, col, q, k, e, scale), sddmm_ref,
             f32 * (2 * e + 2 * nhc + eh), 2.0 * e * h * c, gathers=e * h * c * 4,
             library=library, info=info),
        Step("edge_stats", lambda: ga.edge_stats(row, s, n, e),
             lambda: ga.edge_stats_plain(row, s, n, e), stats_ref,
             f32 * (2 * e + 2 * eh + 3 * nh), 4.0 * e * h, info=info, held=stats_held),
        Step("edge_aggregate", lambda: ga.edge_aggregate(row, col, s, m, l, v, e, mask, keep),
             lambda: ga.edge_aggregate_plain(row, col, s, m, l, v, e, mask, keep),
             aggregate_ref, f32 * (2 * e + eh + 2 * nhc + 2 * nh) + eh, 2.0 * e * h * c,
             gathers=e * h * c * 4, info=info),
        Step("rowdot", lambda: ga.rowdot(g, out, None, m, l),
             lambda: ga.rowdot_plain(g, out, None, m, l), rowdot_ref,
             f32 * (2 * nhc + 6 * nh), 2.0 * nhc, info=info),
        Step("edge_backward",
             lambda: ga.edge_backward(t_row, t_col, pos, q4, s, v, g, e, mask, keep, scale),
             lambda: ga.edge_backward_plain(t_row, t_col, pos, q4, s, v, g, e, mask, keep,
                                            scale),
             backward_ref, f32 * (3 * e + 2 * eh + 4 * nh + 3 * nhc) + eh, 4.0 * e * h * c,
             gathers=e * h * c * 4, info=info),
        Step("weighted_sum_dq", lambda: ga.weighted_sum(row, col, ds, k, e),
             lambda: ga.weighted_sum_plain(row, col, ds, k, e), sum_ref(row, col, k, None),
             f32 * (2 * e + eh + 2 * nhc), 2.0 * e * h * c, gathers=e * h * c * 4, info=info),
        Step("weighted_sum_dk", lambda: ga.weighted_sum(t_row, t_col, ds, q, e, pos),
             lambda: ga.weighted_sum_plain(t_row, t_col, ds, q, e, pos),
             sum_ref(t_row, t_col, q, pos), f32 * (3 * e + eh + 2 * nhc), 2.0 * e * h * c,
             gathers=e * h * c * 4, info=info),
    ]


def reuse_design(row, col, n: int, s_src, s_dst, m, l, z, want) -> dict:
    """The aggregation on the ELL kernel and the COO tail kernel, alpha as
    their values, one head at a time (an ELL pack of the first W entries of
    each row, W the p95 degree rounded up to 8 as ``build_hybrid`` takes
    it, and a COO tail of the rest): its times, and its largest gap to the
    fused output ``want`` over ``want``'s largest value. Runs with the
    libraries in use."""
    import torch

    from ssrg_torch.ops.coo_spmm import coo_accumulate
    from ssrg_torch.ops.ell_spmm import ell_spmm

    h = z.shape[1]
    r, cl = row.long(), col.long()
    deg = torch.bincount(r, minlength=n)
    width = -(-max(int(torch.quantile(deg.double(), 0.95, interpolation="lower")), 1) // 8) * 8
    start = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    start[1:] = torch.cumsum(deg, 0)
    pos = torch.arange(r.numel(), device="cuda") - start[r]
    in_ell = pos < width
    n_pad = -(-n // 256) * 256
    slot = r[in_ell] * width + pos[in_ell]
    cols = torch.zeros(n_pad * width, dtype=torch.int32, device="cuda")
    cols[slot] = col[in_ell]
    cols = cols.view(n_pad, width)
    t_row, t_col = row[~in_ell].contiguous(), col[~in_ell].contiguous()

    def alpha():
        return torch.exp(torch.nn.functional.leaky_relu(s_dst[r] + s_src[cl], GAT_SLOPE)
                         - m[r]) / l[r]

    alpha_ms = card.cuda_ms(alpha, iters=3, warmup=1)
    al = alpha()
    vals = []
    for i in range(h):
        v = torch.zeros(n_pad * width, dtype=torch.float32, device="cuda")
        v[slot] = al[in_ell, i]
        vals.append((v.view(n_pad, width), al[~in_ell, i].contiguous()))
    del al
    z_heads = [z[:, i].contiguous() for i in range(h)]

    def spmm():
        outs = []
        for i in range(h):
            o = ell_spmm(cols, vals[i][0], z_heads[i])[:n]
            coo_accumulate(t_row, t_col, vals[i][1], z_heads[i], o)
            outs.append(o)
        return outs

    gap = max(float((o - want[:, i]).abs().max()) for i, o in enumerate(spmm()))
    return {"ell_width": width, "tail_entries": int(t_row.numel()), "alpha_ms": alpha_ms,
            "spmm_ms": card.cuda_ms(spmm, iters=3, warmup=1),
            "head_copies_ms": card.cuda_ms(lambda: [z[:, i].contiguous() for i in range(h)],
                                           iters=3, warmup=1),
            "gap_to_fused": gap / float(want.abs().max())}


def score_steps(n: int, h: int, c: int, gen) -> list:
    """The score steps on a random z of ``n`` rows at ``h`` heads of ``c``.
    Tolerances, elementwise (u = 2^-24): the scores ``2 (c + 1) u sum |z
    a|``; their ``dz`` ``4 u (|ds_src a_src| + |ds_dst a_dst|)``; ``da``
    against the plain version in float64, ``(ceil(n / 4S) + 5 + P) u sum
    |ds z|`` (S the SMs, P the partial rows, at least the kernel's blocks,
    each of 4 warps: a lane's rows in order, then its block's warps, then
    the blocks)."""
    import torch

    from ssrg_torch.ops import gat_attention as ga

    u = card.UNIT_ROUNDOFF
    z = torch.randn((n, h, c), generator=gen, device="cuda")
    a_src, a_dst = (torch.randn((1, h, c), generator=gen, device="cuda") for _ in range(2))
    ds_src, ds_dst = (torch.randn((n, h), generator=gen, device="cuda") for _ in range(2))

    def scores_ref():
        return (ga.scores_plain(z, a_src, a_dst),
                tuple(2 * (c + 1) * u * (z.abs() * a.abs()).sum(-1) + 1e-30
                      for a in (a_src, a_dst)))

    def score_grad_ref():
        f64 = [t.double() for t in (z, a_src, a_dst, ds_src, ds_dst)]
        sms = torch.cuda.get_device_properties(z.device).multi_processor_count
        depth = -(-n // (4 * sms)) + 5 + ga._score_part_rows(z.device)
        dz = ga.score_grad_plain(z, a_src, a_dst, ds_src, ds_dst)[0]
        return ((dz, *ga.score_grad_plain(*f64)[1:]),
                (4 * u * (ds_src[..., None].abs() * a_src.abs()
                          + ds_dst[..., None].abs() * a_dst.abs()) + 1e-30,
                 *(depth * u * (ds[..., None].abs() * f64[0].abs()).sum(0).view_as(a) + 1e-30
                   for ds, a in ((f64[3], a_src), (f64[4], a_dst)))))

    f32, nh, nhc = 4, n * h, n * h * c
    info = {"n": n, "heads": h, "c": c}
    return [
        Step("scores", lambda: ga.scores(z, a_src, a_dst), lambda: ga.scores_plain(z, a_src, a_dst),
             scores_ref, f32 * (nhc + 2 * h * c + 2 * nh), 4.0 * nhc, info=info),
        Step("score_grad", lambda: ga.score_grad(z, a_src, a_dst, ds_src, ds_dst),
             lambda: ga.score_grad_plain(z, a_src, a_dst, ds_src, ds_dst), score_grad_ref,
             f32 * (2 * nhc + 2 * nh + 4 * h * c), 8.0 * nhc, info=info),
    ]


def gat_cases(args):
    import torch

    from ssrg_torch.data.synthetic import powerlaw_graph
    from ssrg_torch.models.baselines import EdgeList

    def listings():
        yield "powerlaw", EdgeList.attention(powerlaw_graph(
            card.NUM_NODES, card.AVG_DEGREE, card.NUM_FEATURES, seed=card.SEED).adj).to("cuda")
        rows, cols, n = cell_pairs(CELL_GAT, args.seed)
        row, col = rows.int(), cols.int()
        del rows, cols
        # the cell's structure is symmetric: the listing is its own transpose
        yield "gat_cell", EdgeList(row, col, None, n, int(row.numel()), row, col)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if "edges" in args.parts:
        rows, cols, n = cell_pairs(CELL_UNIMP, args.seed, self_loops=False)
        row, col = rows.int(), cols.int()
        del rows, cols
        # the cell's structure is symmetric: the listing is its own transpose
        edges = EdgeList(row, col, None, n, int(row.numel()), row, col)
        with open(CELL_UNIMP) as f:
            rate = float(json.load(f)["attn_dropout"])
        for h, c in GAT_SHAPES:
            yield f"unimp_cell_listing_h{h}_c{c}", edge_steps(edges, h, c, rate, gen)
            torch.cuda.empty_cache()
        del edges, row, col
        torch.cuda.empty_cache()
    if "attention" in args.parts:
        for name, edges in listings():
            for h, c in GAT_SHAPES:
                yield f"{name}_listing_h{h}_c{c}", attention_steps(edges, h, c, gen)
            del edges
            torch.cuda.empty_cache()
    if "scores" in args.parts:  # a z of each graph's rows, no listing held beside it
        with open(CELL_GAT) as f:
            cell_nodes = json.load(f)["dataset"]["num_nodes"]
        for name, n in (("powerlaw", card.NUM_NODES), ("gat_cell", cell_nodes)):
            for h, c in GAT_SHAPES:
                yield f"{name}_rows_h{h}_c{c}", score_steps(n, h, c, gen)
                torch.cuda.empty_cache()


KERNELS = {
    "ell": Kernel("ell_spmm", (("source", {}), ("kTile=32", {"kTile": 32}),
                               ("kTile=128", {"kTile": 128}), ("kBatch=4", {"kBatch": 4}),
                               ("kBatch=8", {"kBatch": 8}), ("kWarps=8", {"kWarps": 8})),
                  ell_cases),
    "coo": Kernel("coo_spmm", (("source", {}), ("kSeg=128", {"kSeg": 128}),
                               ("kSeg=512", {"kSeg": 512}), ("kBatch=2", {"kBatch": 2}),
                               ("kBatch=8", {"kBatch": 8}), ("kQuads=2", {"kQuads": 2}),
                               ("kWarps=8", {"kWarps": 8})),
                  coo_cases),
    # the tensor-core path's tiles: for F <= 128 the window rows of a stage,
    # the ring's stages and the stages of wgmma left in flight across the next
    # stage's barrier; for F > 128 the features of a tile and its stages in flight
    "banded": Kernel("banded_spmm", (("source", {}), ("kTcInFlight=1", {"kTcInFlight": 1}),
                                     ("kTcDepth=64,kTcStages=6,kTcInFlight=1",
                                      {"kTcDepth": 64, "kTcStages": 6, "kTcInFlight": 1}),
                                     ("kTcWideInFlight=0", {"kTcWideInFlight": 0}),
                                     ("kTcWideFeatures=128", {"kTcWideFeatures": 128})),
                     banded_cases),
    "rest": Kernel("rest_spmm", (("source", {}),), rest_cases),
    # per_head: no row on the whole-row path, so the weighted sum and the
    # backward pass at 4 heads of 47 take the per-head scalar lanes
    "gat": Kernel("gat_attention", (("source", {}), ("kBatch=2", {"kBatch": 2}),
                                    ("kBatch=8", {"kBatch": 8}), ("kSeg=128", {"kSeg": 128}),
                                    ("kSeg=512", {"kSeg": 512}), ("kWarps=8", {"kWarps": 8}),
                                    ("per_head", {"kRowFloats": 0}),
                                    ("kRowG=16", {"kRowG": 16}),
                                    ("kRowBatch=4", {"kRowBatch": 4}),
                                    ("kRowBlocks=1", {"kRowBlocks": 1}),
                                    ("kRowBlocks=3", {"kRowBlocks": 3})),
                  gat_cases, rounds=2, plain_timing={"iters": 1, "warmup": 1}),
}


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def measure(key: str, kernel: Kernel, module, libs: dict, case: str, steps: list) -> list:
    """Each step of the case held with each library of ``libs`` and timed in
    turns: its records, the source's library left in use."""
    import torch

    errs, over = {}, {}  # the largest error, and the largest error over its tolerance
    for step in steps:
        want, tols = (as_tuple(t) for t in step.reference())
        errs[step.name], over[step.name] = {}, {}
        for v, lib in libs.items():
            card.use(module, lib)
            got = as_tuple((step.held or step.run)())
            errs[step.name][v] = max(card.hold(f"{key} {case} {step.name} ({v})", a, b, tol)
                                     for a, b, tol in zip(got, want, tols))
            over[step.name][v] = max(float((a - b).abs_().div_(tol).max()) if a.numel() else 0.0
                                     for a, b, tol in zip(got, want, tols))
            del got
        del want, tols
        torch.cuda.empty_cache()
    ms = card.in_turns(module, libs, {s.name: s.run for s in steps}, kernel.rounds)
    card.use(module, libs["source"])
    recs = []
    for step in steps:
        times = {v: ms[v][step.name] for v in libs}
        rec = {"phase": "kernels", "kernel": key, "case": case, "step": step.name, **step.info,
               "max_abs_err": errs[step.name], "max_err_over_tolerance": over[step.name],
               "ms": times["source"], "ms_by_variant": times,
               **card.bound(step.nbytes, step.flops, step.peak),
               "plain_ms": card.cuda_ms(step.plain, **kernel.plain_timing),
               "library_ms": card.cuda_ms(step.library) if step.library else None}
        card.against_bound(f"{key} {case} {step.name}", rec)
        rec["gb_per_s"] = rec.pop("achieved_gb_per_s")
        rec["bound_share_by_variant"] = {v: rec["bound_ms"] / t for v, t in times.items()}
        if step.gathers:
            rec["gather_gb_per_s"] = step.gathers / rec["ms"] / 1e6
        recs.append(rec)
    return recs


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", default=",".join(KERNELS),
                        help="kernels of the table, comma-separated")
    parser.add_argument("--variants", default=None,
                        help="variant names, comma-separated, 'source' among them (default: "
                             "every variant of each kernel)")
    parser.add_argument("--seed", type=int, default=0,
                        help="draws the benchmark cells' graphs and the random operands")
    parser.add_argument("--parts", default="attention,scores,edges",
                        help="gat: attention (the attention's steps on the listings), scores "
                             "(the score steps on a z of each graph's rows), edges (the "
                             "graph-transformer attention's steps on the UniMP cell's listing)")
    args = parser.parse_args()
    keys = args.kernel.split(",")
    unknown = sorted(set(keys) - set(KERNELS))
    if unknown:
        parser.error(f"unknown kernels {unknown}; the table has {list(KERNELS)}")
    wanted = None if args.variants is None else args.variants.split(",")
    if wanted is not None:
        if "source" not in wanted:
            parser.error("the variants are held to each other beside 'source': name it")
        known = {name for key in keys for name, _ in KERNELS[key].variants}
        if set(wanted) - known:
            parser.error(f"no kernel of {keys} has the variants {sorted(set(wanted) - known)}")
    if not torch.cuda.is_available():
        print("kernels: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    for key in keys:
        kernel = KERNELS[key]
        module = importlib.import_module(f"ssrg_torch.ops.{kernel.module}")
        libs = card.build_variants(module, [(name, changes) for name, changes in kernel.variants
                                            if wanted is None or name in wanted])
        for case, steps in kernel.cases(args):
            for rec in measure(key, kernel, module, libs, case, steps):
                card.emit(rec)
            del steps
            torch.cuda.empty_cache()
    print(card.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
