"""The kernel wrappers of ``ssrg_torch`` (ELL, banded, rest and COO SpMM): each
plain version against a float64 numpy product on ragged packs, each
wrapper's refusals, and, on a CUDA card, each hand-written kernel against
its plain version.

On a card each kernel is also held to its plain version on the 169,343-node
graphs it runs on in practice (the ``*_CARD_CASES`` lists: each ragged list
and the names of full-size cases, which only the card's tests take).

This file imports neither jax nor ``ssrg_tpu``, so the ``cuda``-marked
tests also run where only the port is installed:

    python -m pytest tests/test_torch_port_kernels.py -m cuda --noconftest
"""

import dataclasses
import functools
import os
import re
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ssrg_torch.ops import _nvcc, sparse
from ssrg_torch.ops import banded_spmm as banded_spmm_module
from ssrg_torch.ops import ell_spmm as ell_spmm_module
from ssrg_torch.ops.banded_spmm import banded_spmm, banded_spmm_plain
from ssrg_torch.ops.coo_spmm import coo_accumulate, coo_accumulate_plain
from ssrg_torch.ops.ell_spmm import ell_spmm, ell_spmm_plain
from ssrg_torch.ops.pallas_rest import build_rest_segmented
from ssrg_torch.ops.rest_spmm import rest_spmm, rest_spmm_plain

# the full-size graphs and packs, built as tools/kernels.py builds them (last
# on the path, so that no file of tools/ shadows another top-level name)
sys.path.append(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import card  # noqa: E402  (tools/card.py)

# f32 unit roundoff: a kernel and its plain version that sum the same c terms
# of a row in another order differ by at most 2 * c * u * sum|term|
UNIT_ROUNDOFF = 2.0 ** -24

ELL_CASES = [  # (rows, n, width, f, empty_fraction[, kind])
    (37, 50, 1, 128, 0.0),
    (1003, 777, 7, 50, 0.1),
    (61, 40, 40, 300, 0.2),
    (13, 20, 3, 48, 0.5),
    (64, 300, 24, 128, 0.1, "holes"),      # zero slots inside rows and padded row ends
    (40, 50, 16, 32, 0.0, "all_zero"),     # no nonzero slot at all
    (50, 400, 64, 128, 0.0, "full"),       # every slot nonzero, two votes a row
    (100, 80, 5, 4, 0.1, "holes"),         # F = 4, less than one tile
    (100, 80, 12, 16, 0.1, "holes"),       # F = 16
    (100, 80, 12, 20, 0.1, "holes"),       # F = 20, a ragged tile
    (90, 200, 33, 130, 0.1, "holes"),      # F = 130: scalar loads, several tiles
    (70, 120, 20, 300, 0.1, "holes"),      # F = 300, a ragged last tile
    (80, 120, 16, 296, 0.1, "holes"),      # F = 296 (hidden + classes of an augmented
                                           # graph): float4 lanes, a last tile of 40
    (99, 60, 9, 48, 0.1, "misaligned"),    # x 4 bytes off 16-byte alignment
    (120, 90, 11, 3, 0.1, "holes"),        # F = 3, a class count: scalar lanes only
    (130, 150, 9, 1024, 0.1, "holes"),     # F = 1,024, the Chebyshev impulse block
    (200, 160, 12, 128, 0.0, "stored_zeros"),  # zero weights on real columns, signed
]


ELL_CARD_CASES = ELL_CASES + ["headline", "powerlaw", "headline_l2_resident"]


def _ell_id(case):
    if isinstance(case, str):
        return case
    return "r{}_n{}_w{}_f{}".format(*case[:4]) + (f"_{case[5]}" if len(case) > 5 else "")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


# --- the full-size cases (a card only) ----------------------------------------


@functools.cache
def _full_hybrid(name):
    """The hybrid pack of ``D^-1/2 A D^-1/2`` of the headline (uniform
    degrees) or the power-law graph, and its features, on the host."""
    from ssrg_torch.data.synthetic import powerlaw_graph, random_graph
    from ssrg_torch.ops.normalize import sym_norm

    if name == "headline":
        g = random_graph(card.NUM_NODES, card.AVG_DEGREE, card.NUM_FEATURES,
                         num_classes=card.NUM_CLASSES, seed=card.SEED)
    else:
        g = powerlaw_graph(card.NUM_NODES, card.AVG_DEGREE, card.NUM_FEATURES, seed=card.SEED)
    return sparse.build_hybrid(sym_norm(g.adj, 0.5)), torch.as_tensor(g.x)


def _full_locality(engine, bf16, device):
    """``prepare``'s reorder path for ``engine`` on the card: its pack and
    the renumbered features. ``reorder_banded`` on the band whose ids RCM
    has to find again, ``reorder_tiled`` on ``community_graph`` (label
    propagation finds the clusters)."""
    ds = card.banded_dataset() if engine == "reorder_banded" else card.community_dataset()
    return card.locality_pack(ds, engine, bf16, device)


def _ell_case(rows, n, width, f, empty, kind=None, seed=0):
    """``kind="holes"`` zeroes a third of the slots and pads each row's end
    with column 0 and weight 0, as the packer does; ``"all_zero"`` zeroes
    every slot; ``"full"`` keeps every slot nonzero; ``"misaligned"`` is
    ``"holes"`` with an x that :func:`_ell_tensors` places off alignment;
    ``"stored_zeros"`` zeroes a third of the weights and keeps their columns
    and every row's full width, as the magnetic imaginary part stores
    ``sin(0) = 0`` on reciprocal edges and self-loops."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n, (rows, width)).astype(np.int32)
    vals = rng.normal(size=(rows, width)).astype(np.float32)
    if kind == "full":
        vals = rng.uniform(0.1, 1.0, size=(rows, width)).astype(np.float32)
    elif kind == "all_zero":
        vals[:] = 0.0
    elif kind == "stored_zeros":
        vals[rng.uniform(size=(rows, width)) < 1 / 3] = 0.0
    elif kind in ("holes", "misaligned"):
        vals[rng.uniform(size=(rows, width)) < 1 / 3] = 0.0
        pad = np.arange(width)[None, :] >= rng.integers(0, width + 1, rows)[:, None]
        cols[pad], vals[pad] = 0, 0.0
    drop = rng.uniform(size=rows) < empty
    cols[drop], vals[drop] = 0, 0.0
    x = rng.normal(size=(n, f)).astype(np.float32)
    dense = np.zeros((rows, n))
    np.add.at(dense, (np.repeat(np.arange(rows), width), cols.reshape(-1)), vals.reshape(-1))
    return cols, vals, x, dense @ x.astype(np.float64)


def _ell_tensors(case, device):
    """``(cols, vals, x)`` of an ``ELL_CARD_CASES`` entry on ``device``; a
    ``"misaligned"`` case's x is contiguous but 4 bytes off 16-byte
    alignment."""
    if isinstance(case, str):
        hyb, x = _full_hybrid(case.removesuffix("_l2_resident"))
        cols = hyb.ell.cols
        if case.endswith("_l2_resident"):
            cols, x = torch.remainder(cols, card.L2_ROWS), x[:card.L2_ROWS]
        return cols.to(device), hyb.ell.vals.to(device), x.to(device)
    cols, vals, x, _ = _ell_case(*case)
    c, v = torch.from_numpy(cols).to(device), torch.from_numpy(vals).to(device)
    xx = torch.from_numpy(x).to(device)
    if case[5:] == ("misaligned",):
        xx = torch.empty(x.size + 1, device=device)[1:].view(x.shape).copy_(xx)
        assert xx.data_ptr() % 16 != 0
    return c, v, xx


@pytest.mark.parametrize("case", ELL_CASES, ids=_ell_id)
def test_ell_spmm_plain_ragged(case):
    expected = _ell_case(*case)[3]
    before = ell_spmm.launches
    out = ell_spmm(*_ell_tensors(case, "cpu"))
    assert ell_spmm.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(out.numpy(), expected, rtol=3e-5, atol=3e-5)


def test_ell_spmm_refuses_what_the_kernel_does_not_take():
    cols, vals, x, _ = _ell_case(16, 20, 4, 8, 0.0)
    c, v, xx = torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(x)
    with pytest.raises(TypeError):
        ell_spmm(c.long(), v, xx)
    with pytest.raises(TypeError):
        ell_spmm(c, v, xx.double())
    with pytest.raises(TypeError):
        ell_spmm(c, v[:, :3].contiguous(), xx)
    with pytest.raises(TypeError):
        ell_spmm(c, v, xx.t())  # not contiguous
    with pytest.raises(TypeError):
        ell_spmm(c, v, torch.empty(20, 8, device="meta"))
    with pytest.raises(ValueError):
        sparse.build_ell(sp.random(20, 20, 0.2, format="csr", random_state=0)).spmm(xx[:10])


def _ell_tolerance(c, v, xx):
    # the kernel adds only the nonzero slots, the plain version every slot, in
    # another order: each within W * u * sum|v * x| of the exact sum
    width = c.shape[1]
    return 2.0 * width * UNIT_ROUNDOFF * ell_spmm_plain(c, v.abs(), xx.abs()) + 1e-30


@pytest.mark.cuda
@pytest.mark.parametrize("case", ELL_CARD_CASES, ids=_ell_id)
def test_ell_spmm_kernel_matches_plain(cuda_device, case):
    c, v, xx = _ell_tensors(case, cuda_device)
    before = ell_spmm.launches
    out = ell_spmm(c, v, xx)
    torch.cuda.synchronize()
    assert ell_spmm.launches == before + 1
    diff = (out - ell_spmm_plain(c, v, xx)).abs()
    assert bool((diff <= _ell_tolerance(c, v, xx)).all()), float(diff.max())


def test_ell_tile_is_the_kernel_sources():
    # ell_spmm.TILE reports the kernel's feature tile; the source fixes it
    with open(_nvcc.source("ell_spmm")) as f:
        tiles = re.findall(r"constexpr int kTile = (\d+);", f.read())
    assert tiles == [str(ell_spmm_module.TILE)]


# --- banded SpMM -------------------------------------------------------------

BANDED_CASES = [  # (nb, rb, w, n, f, blocks dtype, round_x[, kind])
    (5, 64, 128, 300, 50, "f32", False),      # ragged F
    (4, 64, 256, 200, 16, "f32", False),      # windows past N, empty row blocks
    (3, 100, 96, 290, 130, "bf16", False),    # rb not a multiple of the tile, F > 128
    (6, 32, 48, 150, 8, "f32", True),         # a bf16 window over f32 blocks
    (3, 16, 1024, 1300, 128, "f32", False, "dense_rows"),   # rows with every entry nonzero
    (3, 16, 1040, 1300, 64, "bf16", False, "dense_rows"),   # the same in bf16
    (4, 24, 37, 120, 16, "f32", False),       # W not a multiple of 4
    (3, 40, 45, 100, 20, "bf16", False),      # W not a multiple of 8
    (4, 32, 64, 130, 4, "f32", False),        # F = 4
    (4, 64, 256, 400, 128, "f32", False),     # F = 128, the last window past N
    (3, 128, 384, 600, 128, "bf16", False),   # the same in bf16
    # the tensor-core path's tile edges (128 rows; for F <= 128 a tile of 128
    # features and 128 window rows a stage, above it 256 features and 64
    # window rows a stage), all bf16
    (3, 100, 63, 300, 100, "bf16", False),    # rb 100 < a row tile, W 63 < a stage, F 100
    (3, 200, 65, 500, 136, "bf16", True),     # rb 200: a ragged second row tile; W 65, not
                                              # a multiple of 8; F 136: a ragged wide tile
    (3, 100, 1040, 1300, 8, "bf16", False),   # W 1,040: 8 stages and a ragged one; F 8
    (3, 200, 256, 700, 256, "bf16", False),   # F 256: one whole wide tile
    (3, 100, 130, 500, 300, "bf16", False),   # F 300: a wide tile and a ragged one; W 130:
                                              # 2 wide stages and a ragged one
    (2, 64, 70, 300, 200, "bf16", False, "misaligned"),    # a wide tile, scalar pack loads
    (2, 130, 192, 500, 128, "bf16", False, "dense_block"),  # every entry of block 0 nonzero
    (3, 64, 128, 300, 36, "bf16", False, "misaligned"),    # pack and x off 16-byte alignment
]
BANDED_CARD_CASES = BANDED_CASES + [
    (2, 64, 128, 400, 1024, "bf16", False),   # F 1,024: four wide tiles
    (3, 128, 96, 300, 4, "bf16", False),      # F 4 on the tensor cores
    "banded_f32_pack", "banded_bf16_pack", "bench_banded_dense",
]


def _banded_id(case):
    return case if isinstance(case, str) else "nb{}_rb{}_w{}_n{}_f{}_{}_{}".format(*case)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _banded_case(nb, rb, w, n, f, dtype, round_x, kind=None, seed=0):
    """``kind="dense_rows"`` makes every entry of block 0's first three rows
    nonzero, ``"dense_block"`` every entry of block 0; ``"misaligned"`` is
    applied by :func:`_banded_tensors`."""
    rng = np.random.default_rng(seed)
    blocks = rng.normal(size=(nb, rb, w)).astype(np.float32)
    blocks[rng.uniform(size=(nb, rb, w)) < 0.7] = 0.0
    blocks[1] = 0.0                                    # an empty row block
    if kind == "dense_rows":
        blocks[0, :3] = rng.uniform(0.1, 1.0, size=(3, w)).astype(np.float32)
    elif kind == "dense_block":
        blocks[0] = rng.uniform(0.1, 1.0, size=(rb, w)).astype(np.float32)
    los = (rng.integers(0, max(n - w // 2, 1), nb) // 16 * 16).astype(np.int32)
    los[-1] = (n - 8) // 16 * 16                       # its window runs past N
    x = rng.normal(size=(n, f)).astype(np.float32)
    bt = torch.from_numpy(blocks)
    if dtype == "bf16":
        bt = bt.bfloat16()
        blocks = bt.float().numpy()
    xt = _bf16(x) if (round_x or dtype == "bf16") else x
    xp = np.concatenate([xt, np.zeros((int(los.max()) + w, f), np.float32)]).astype(np.float64)
    expected = np.concatenate([blocks[b] @ xp[los[b]:los[b] + w] for b in range(nb)])
    return bt, torch.from_numpy(los), torch.from_numpy(x), expected


def _misaligned(t, device):
    """A contiguous copy of ``t`` on ``device`` one element past an aligned
    start (2 bytes for bf16, 4 for f32)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _banded_tensors(case, device):
    blocks, los, x, expected = _banded_case(*case)
    if len(case) > 7 and case[7] == "misaligned":
        blocks, x = _misaligned(blocks, device), _misaligned(x, device)
        assert blocks.data_ptr() % 16 and x.data_ptr() % 16
    return blocks.to(device), los.to(device), x.to(device), expected


@pytest.mark.parametrize("case", BANDED_CASES, ids=_banded_id)
def test_banded_spmm_plain_ragged(case):
    blocks, los, x, expected = _banded_tensors(case, "cpu")
    before = banded_spmm.launches
    out = banded_spmm(blocks, los, x, round_x=case[6])
    assert banded_spmm.launches == before
    assert out.shape == (case[0] * case[1], case[4]) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), expected, rtol=3e-5, atol=3e-5)


def test_banded_spmm_refuses_what_the_kernel_does_not_take():
    blocks, los, x, _ = _banded_case(*BANDED_CASES[0])
    for args in ((blocks.double(), los, x), (blocks, los.long(), x), (blocks, los, x.double()),
                 (blocks, los[:2], x), (blocks[0], los, x), (blocks, los, x.t()),
                 (blocks, los, torch.empty(300, 50, device="meta"))):
        with pytest.raises(TypeError):
            banded_spmm(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("round_x", [False, True])
def test_banded_spmm_path_is_picked_by_the_blocks_type(dtype, round_x):
    """The path is the blocks' type's, with either window; on the CPU the
    wrapper runs the plain version and counts no launch on any path."""
    blocks = torch.zeros((2, 16, 32), dtype=dtype)
    blocks[:, :, ::3] = 0.5
    los, x = torch.tensor([0, 16], dtype=torch.int32), torch.randn(40, 8)
    want = "tensor_core" if dtype == torch.bfloat16 else "stream"
    assert banded_spmm_module.path(blocks) == want
    assert banded_spmm_module.PATHS.index(want) == {"stream": 0, "tensor_core": 1}[want]
    before = dict(banded_spmm.path_launches)
    out = banded_spmm(blocks, los, x, round_x)
    assert banded_spmm.path_launches == before
    torch.testing.assert_close(out, banded_spmm_plain(blocks, los, x, round_x), rtol=0, atol=0)


def _banded_tolerance(blocks, los, x, round_x):
    """Elementwise bound on |kernel - plain| for rows of c nonzero entries,
    S = sum|a * x| of the row. The stream path adds the same products as the
    plain version in another order: each within c * 2^-24 * S of the exact
    sum, 2 * c * 2^-24 * S apart. The tensor-core path (the derivation is in
    csrc/banded_spmm.cu, on Fasi et al.'s 2021 model of the MMA's sum, which
    they measured on Volta to Ampere and is assumed for Hopper's wgmma; the
    card's observed error, tools/kernels.py's max_err_over_tolerance, backs it):
    an MMA group with g nonzero products loses less than (g + 2) * 2^-23 * S
    to its alignment and normalization by truncation, 3c * 2^-23 * S over the
    row, and the plain version's f32 sum c * 2^-24 * S more: 7 * c * 2^-24 *
    S."""
    counts = (blocks != 0).sum(dim=2).reshape(-1, 1)
    factor = 7.0 if banded_spmm_module.path(blocks) == "tensor_core" else 2.0
    return factor * counts * UNIT_ROUNDOFF * banded_spmm_plain(blocks.abs(), los, x.abs(),
                                                               round_x)


def _banded_card_tensors(case, device):
    """``(blocks, los, x, round_x)`` of a ``BANDED_CARD_CASES`` entry on
    ``device``: the ``reorder_banded`` packs (f32: the stream path; bf16 with
    a bf16 window: the tensor cores) and the bench's dense bf16 pack."""
    if case == "bench_banded_dense":
        from ssrg_torch import bench

        return (*bench.banded_tier_inputs(card.NUM_FEATURES, device), True)
    if isinstance(case, str):
        pack, x = _full_locality("reorder_banded", case == "banded_bf16_pack", device)
        return pack.blocks, pack.los, x, pack.window_bf16
    return (*_banded_tensors(case, device)[:3], case[6])


@pytest.mark.cuda
@pytest.mark.parametrize("case", BANDED_CARD_CASES, ids=_banded_id)
def test_banded_spmm_kernel_matches_plain(cuda_device, case):
    blocks, los, x, round_x = _banded_card_tensors(case, cuda_device)
    chosen = banded_spmm_module.path(blocks)
    before, before_path = banded_spmm.launches, banded_spmm.path_launches[chosen]
    out = banded_spmm(blocks, los, x, round_x=round_x)
    torch.cuda.synchronize()
    assert banded_spmm.launches == before + 1
    assert banded_spmm.path_launches[chosen] == before_path + 1
    assert chosen == ("tensor_core" if blocks.dtype == torch.bfloat16 else "stream")
    tol = _banded_tolerance(blocks, los, x, round_x)
    diff = (out - banded_spmm_plain(blocks, los, x, round_x)).abs()
    assert bool((diff <= tol + 1e-30).all()), float(diff.max())


@pytest.mark.cuda
def test_banded_tensor_core_path_multiplies_zero_entries(cuda_device):
    """An Inf of x under a zero entry gives NaN on the tensor-core path, as
    in the plain version and the reference's dense dot; the other outputs
    stay within the path's bound."""
    blocks, los, x, _ = _banded_case(3, 64, 128, 300, 16, "bf16", False)
    k = int((blocks[0, 0] == 0).nonzero()[0])
    x[int(los[0]) + k, 0] = float("inf")
    blocks, los, x = blocks.to(cuda_device), los.to(cuda_device), x.to(cuda_device)
    out = banded_spmm(blocks, los, x)
    plain = banded_spmm_plain(blocks, los, x)
    torch.cuda.synchronize()
    assert bool(out[0, 0].isnan())
    assert torch.equal(out.isnan(), plain.isnan()) and torch.equal(out.isinf(), plain.isinf())
    finite = plain.isfinite()
    tol = _banded_tolerance(blocks, los, x.nan_to_num(posinf=0.0), False)
    assert bool(((out - plain).abs() <= tol + 1e-30)[finite].all())


# --- rest SpMM ----------------------------------------------------------------

REST_CASES = [  # (n_rows, n_cols, edges, row_block, chunk, f, long_row, gather_bf16[, rows])
    (700, 700, 2100, 64, 128, 50, False, False),   # ragged F
    (512, 512, 0, 64, 128, 16, False, True),       # edge-free row blocks (4 edges below)
    (300, 300, 900, 32, 64, 37, True, False),      # one row across several chunks
    (200, 350, 600, 64, 128, 160, False, True),    # rectangular table, F > 128
    (600, 700, 0, 64, 128, 128, False, False, "short"),   # F = 128, rows of 1-3 entries
    (512, 400, 0, 64, 96, 128, False, True, "pad_last"),  # blocks' last rows edge-free, pads
]
REST_CARD_CASES = REST_CASES + ["community_rest_bf16", "community_rest_f32"]


def _rest_id(case):
    return case if isinstance(case, str) else "n{}_m{}_e{}_rb{}_c{}_f{}_{}_{}".format(*case)


def _rest_case(n, m, e, rb, chunk, f, long_row, gather_bf16, rows=None, seed=0):
    """``rows="short"`` gives row r 1 + r % 3 entries; ``"pad_last"`` the
    same but none on each block's last row, whose block still has pads."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, e), rng.integers(0, m, e)
    if rows is not None:
        counts = 1 + np.arange(n) % 3
        if rows == "pad_last":
            counts[rb - 1::rb] = 0
        r = np.repeat(np.arange(n), counts)
        c = rng.integers(0, m, r.size)
    elif e == 0:
        r, c = np.array([0, 1, 500, 500]), np.array([3, 4, 5, 6])
    if long_row:
        r, c = np.concatenate([r, np.full(m, 17)]), np.concatenate([c, np.arange(m)])
    adj = sp.csr_matrix((rng.uniform(0.1, 1.0, r.size).astype(np.float32), (r, c)),
                        shape=(n, m))
    adj.sum_duplicates()
    pack = build_rest_segmented(adj, row_block=rb, chunk=chunk, gather_bf16=gather_bf16,
                                device="cpu")
    x = rng.normal(size=(m, f)).astype(np.float32)
    coo = adj.tocoo()
    if gather_bf16:
        terms = _bf16(_bf16(x[coo.col]) * _bf16(coo.data)[:, None])
    else:
        terms = x[coo.col] * coo.data[:, None]
    expected = np.zeros((pack.row_ptr.shape[0] - 1, f))
    np.add.at(expected, coo.row, terms.astype(np.float64))
    return pack, torch.from_numpy(x), expected


@pytest.mark.parametrize("case", REST_CASES, ids=_rest_id)
def test_rest_spmm_plain_ragged(case):
    pack, x, expected = _rest_case(*case)
    before = rest_spmm.launches
    out = rest_spmm(pack.row_ptr, pack.row_end, pack.cols, pack.vals, x, gather_bf16=case[7])
    assert rest_spmm.launches == before
    np.testing.assert_allclose(out.numpy(), expected, rtol=3e-5, atol=3e-5)


def test_rest_spmm_refuses_what_the_kernel_does_not_take():
    pack, x, _ = _rest_case(*REST_CASES[0])
    rp, re, c, v = pack.row_ptr, pack.row_end, pack.cols, pack.vals
    for args in ((rp.int(), re, c, v, x), (rp, re.int(), c, v, x), (rp, re, c.long(), v, x),
                 (rp, re, c, v.double(), x), (rp, re, c, v[:, :5], x), (rp[None], re, c, v, x),
                 (rp, re[:-1], c, v, x), (rp, re, c, v, x[0]), (rp, re, c, v, x.t()),
                 (rp, re, c, v, torch.empty(700, 50, device="meta"))):
        with pytest.raises(TypeError):
            rest_spmm(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", REST_CARD_CASES, ids=_rest_id)
def test_rest_spmm_kernel_matches_plain(cuda_device, case):
    if isinstance(case, str):  # the reorder_tiled community rest, bf16 or f32 gathers
        pack, x = _full_locality("reorder_tiled", True, cuda_device)
        pack = dataclasses.replace(pack.rest, gather_bf16=case.endswith("bf16"))
    else:
        pack, x, _ = _rest_case(*case)
        pack, x = pack.to(cuda_device), x.to(cuda_device)
    rp, re, c, v, bf16 = pack.row_ptr, pack.row_end, pack.cols, pack.vals, pack.gather_bf16
    before = rest_spmm.launches
    out = rest_spmm(rp, re, c, v, x, bf16)
    torch.cuda.synchronize()
    assert rest_spmm.launches == before + 1
    # the same terms of a row as the plain version, summed in another order
    counts = (re - rp[:-1])[:, None]
    tol = 2.0 * counts * UNIT_ROUNDOFF * rest_spmm_plain(rp, re, c, v.abs(), x.abs(), bf16)
    diff = (out - rest_spmm_plain(rp, re, c, v, x, bf16)).abs()
    assert bool((diff <= tol + 1e-30).all()), float(diff.max())


# --- COO segmented sum -------------------------------------------------------

COO_CASES = [  # (n_rows, n_cols, f, kind)
    (300, 400, 64, "hub"),          # one row of 3,000 entries: a dozen segments
    (300, 400, 256, "hub"),         # the same at F = 256: two float4 tiles
    (500, 300, 47, "straddle"),     # rows of 1 to 600 entries: runs across segment edges
    (500, 300, 1, "straddle"),      # F = 1
    (500, 300, 3, "straddle"),      # F = 3
    (500, 300, 64, "straddle"),     # F = 64
    (500, 300, 256, "straddle"),    # F = 256
    (200, 200, 64, "misaligned"),   # x and out 4 bytes off 16-byte alignment: scalar lanes
    (200, 200, 47, "padded"),       # build_coo's pack, its trailing padding left out by nnz
    (200, 200, 64, "padded_all"),   # the same pack summed over every entry (nnz None)
    (200, 200, 64, "unsorted"),     # a shard's entries, padded with row 0 after the last row
    (200, 200, 64, "empty"),        # no entry at all (build_coo's one padded chunk)
    (260, 100, 130, "last_row"),    # 700 entries on row n_rows - 1; F = 130: a ragged tile
]
COO_CARD_CASES = COO_CASES + ["headline_tail", "powerlaw_tail"]


def _coo_id(case):
    return case if isinstance(case, str) else "n{}_m{}_f{}_{}".format(*case)


def _coo_case(n_rows, n_cols, f, kind, seed=0):
    """``(row, col, val, x, out, nnz)`` on the CPU: ``out`` holds random
    values (a hybrid adds its tail into the ELL term's result), ``nnz`` is
    what the caller passes (None: every entry)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 12, n_rows)
    if kind == "hub":
        lengths = rng.integers(0, 8, n_rows)
        lengths[7] = 3000
    elif kind == "straddle":
        lengths = rng.integers(1, 601, n_rows)
    elif kind == "last_row":
        lengths = rng.integers(0, 3, n_rows)
        lengths[-1] = 700
    elif kind == "empty":
        lengths[:] = 0
    rows = np.repeat(np.arange(n_rows), lengths)
    cols = rng.integers(0, n_cols, rows.size)
    vals = rng.normal(size=rows.size).astype(np.float32)
    nnz = None
    if kind in ("padded", "padded_all", "empty"):
        pack = sparse.build_coo(sp.coo_matrix((vals, (rows, cols)), shape=(n_rows, n_cols)),
                                chunk=512)
        assert pack.nnz_padded > pack.nnz
        row, col, val = pack.row, pack.col, pack.val
        nnz = None if kind == "padded_all" else pack.nnz
    else:
        if kind == "unsorted":
            rows, cols = (np.concatenate([a, np.zeros(300, a.dtype)]) for a in (rows, cols))
            vals = np.concatenate([vals, np.zeros(300, np.float32)])
        row = torch.from_numpy(rows.astype(np.int32))
        col = torch.from_numpy(cols.astype(np.int32))
        val = torch.from_numpy(vals)
    x = torch.from_numpy(rng.normal(size=(n_cols, f)).astype(np.float32))
    out = torch.from_numpy(rng.normal(size=(n_rows, f)).astype(np.float32))
    return row, col, val, x, out, nnz


def _coo_tensors(case, device):
    """A ``COO_CARD_CASES`` entry on ``device``; a ``"misaligned"`` case's x
    and out are contiguous but 4 bytes off 16-byte alignment; a full-size
    hybrid pack's tail adds into random values, as into its ELL term's."""
    if isinstance(case, str):
        hyb, x = _full_hybrid(case.removesuffix("_tail"))
        t = hyb.tail
        out = np.random.default_rng(0).normal(size=(t.n_rows, x.shape[1])).astype(np.float32)
        return (t.row.to(device), t.col.to(device), t.val.to(device), x.to(device),
                torch.from_numpy(out).to(device), t.nnz)
    row, col, val, x, out, nnz = _coo_case(*case)
    if case[3] == "misaligned":
        x, out = _misaligned(x, device), _misaligned(out, device)
        assert x.data_ptr() % 16 and out.data_ptr() % 16
    return row.to(device), col.to(device), val.to(device), x.to(device), out.to(device), nnz


@pytest.mark.parametrize("case", COO_CASES, ids=_coo_id)
def test_coo_accumulate_plain_ragged(case):
    row, col, val, x, out, nnz = _coo_tensors(case, "cpu")
    n = row.shape[0] if nnz is None else nnz
    want = out.numpy().astype(np.float64)
    np.add.at(want, row[:n].numpy(),
              val[:n].numpy()[:, None].astype(np.float64) * x.numpy()[col[:n].numpy()])
    before = coo_accumulate.launches
    got = coo_accumulate(row, col, val, x, out, nnz, chunk=1000)
    assert got is out and coo_accumulate.launches == before  # the plain version, in place
    np.testing.assert_allclose(out.numpy(), want, rtol=3e-5, atol=3e-5)


def test_coo_adj_on_the_cpu_is_the_old_chunk_loop():
    """``COOAdj.accumulate`` on CPU tensors equals the chunked
    ``index_select``, scaling and ``index_add_`` over every padded entry bit
    for bit, and counts no kernel launch: three torch operations a chunk."""
    row, col, val, x, out, _ = _coo_case(500, 300, 47, "straddle")
    adj = sp.coo_matrix((val.numpy(), (row.numpy(), col.numpy())), shape=(500, 300))
    pack = sparse.build_coo(adj, chunk=1 << 14)
    assert pack.chunks > 1 and pack.nnz_padded > pack.nnz
    old = out.clone()
    for s in range(0, pack.nnz_padded, pack.chunk):
        r, c, v = (t[s:s + pack.chunk] for t in (pack.row, pack.col, pack.val))
        old.index_add_(0, r, x.index_select(0, c) * v[:, None])
    before = coo_accumulate.launches
    got = pack.accumulate(out, x)
    assert coo_accumulate.launches == before
    assert got is out and torch.equal(out, old)
    assert pack.launches(torch.device("cpu")) == 3 * pack.chunks
    assert pack.launches(torch.device("cuda")) == 1
    assert sparse.build_coo(sp.coo_matrix((300, 300))).launches(torch.device("cuda")) == 0


def test_coo_accumulate_refuses_what_the_kernel_does_not_take():
    row, col, val, x, out, _ = _coo_case(50, 40, 8, "straddle")
    for args in ((row.long(), col, val, x, out), (row, col.long(), val, x, out),
                 (row, col, val.double(), x, out), (row, col, val, x.double(), out),
                 (row, col, val, x, out.double()), (row, col[:-1], val, x, out),
                 (row[None], col, val, x, out), (row, col, val, x[0], out),
                 (row, col, val, x, out[:, :5]), (row, col, val, x.t(), out),
                 (row[::2], col[::2], val[::2], x, out),
                 (row, col, val, x, torch.empty(50, 8, device="meta"))):
        with pytest.raises(TypeError):
            coo_accumulate(*args)
    with pytest.raises(TypeError):
        coo_accumulate(row, col, val, x, out, nnz=row.shape[0] + 1)
    for grad in ("val", "x", "out"):
        args = dict(row=row, col=col, val=val, x=x, out=out.clone())
        args[grad] = args[grad].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="differentiable_adjacency"):
            coo_accumulate(**args)
        with torch.no_grad():
            coo_accumulate(**args)


def _coo_tolerance(row, col, val, x, out, nnz):
    """The kernel sums a row's terms in entry order within a segment and the
    segments' partial sums by atomics, the plain version in its own order:
    each within ``(c + 1) u (|out| + sum |v x|)`` of the exact sum, c the
    row's entry count, so they differ by at most twice that."""
    n = row.shape[0] if nnz is None else nnz
    counts = torch.bincount(row[:n].long(), minlength=out.shape[0])[:, None]
    mag = coo_accumulate_plain(row, col, val.abs(), x.abs(), out.abs(), nnz)
    return 2.0 * (counts + 1) * UNIT_ROUNDOFF * mag + 1e-30


@pytest.mark.cuda
@pytest.mark.parametrize("case", COO_CARD_CASES, ids=_coo_id)
def test_coo_accumulate_kernel_matches_plain(cuda_device, case):
    row, col, val, x, out, nnz = _coo_tensors(case, cuda_device)
    want = coo_accumulate_plain(row, col, val, x, out.clone(), nnz)
    tol = _coo_tolerance(row, col, val, x, out, nnz)
    before = coo_accumulate.launches
    got = coo_accumulate(row, col, val, x, out, nnz)
    torch.cuda.synchronize()
    assert got is out
    entries = row.shape[0] if nnz is None else nnz
    assert coo_accumulate.launches == before + (entries > 0)
    diff = (out - want).abs()
    assert bool((diff <= tol).all()), float(diff.max())


@pytest.mark.cuda
def test_coo_kernel_leaves_out_the_padding_it_is_told_of(cuda_device):
    """Given the real entry count, the kernel does not add the pack's padding
    (row 0, column 0, value 0): with an Inf in x's row 0 and no real entry
    on column 0, out stays finite, where summing every entry (nnz None) makes
    out's row 0 NaN there, as the plain version and the reference do."""
    row, col, val, x, out, _ = _coo_case(200, 200, 64, "straddle")
    keep = col != 0
    real = sp.coo_matrix((val[keep].numpy(), (row[keep].numpy(), col[keep].numpy())),
                         shape=(200, 200))
    pack = sparse.build_coo(real, chunk=1 << 14)
    assert pack.nnz_padded > pack.nnz
    pack = pack.to(cuda_device)
    x, out = x.to(cuda_device), out.to(cuda_device)
    x[0, 3] = float("inf")
    told = pack.accumulate(out.clone(), x)
    every = coo_accumulate(pack.row, pack.col, pack.val, x, out.clone())
    plain = coo_accumulate_plain(pack.row, pack.col, pack.val, x, out.clone())
    torch.cuda.synchronize()
    assert bool(told.isfinite().all())
    assert bool(every[0, 3].isnan()) and bool(plain[0, 3].isnan())
    assert int(every.isnan().sum()) == 1 and bool(every.isfinite().sum() == every.numel() - 1)


# --- gradients: the ELL kernel under autograd, the forward-only kernels ------


def _transposed_ell(cols, vals, n_cols):
    """The ELL pack of ``A^T`` for an ELL pack of ``A`` (duplicate columns
    of a row summed, zero slots dropped)."""
    rows, width = cols.shape
    a = sp.csr_matrix((vals.reshape(-1), (np.repeat(np.arange(rows), width), cols.reshape(-1))),
                      shape=(rows, n_cols))
    a.sum_duplicates()
    a.eliminate_zeros()
    return sparse.build_ell(a.T.tocsr())


def _ell_grad_check(case, device):
    """``x``'s gradient through the ELL ``Function`` (backward: the kernel on
    the transposed pack) against autograd through ``ell_spmm_plain``, for
    the same output gradient. Each sums a column's terms of A in its own
    order (the transposed pack summed duplicate slots once more): within
    ``2 (c + 1) u sum|v g|``, c the longest column."""
    c, v, xx = _ell_tensors(case, device)
    (rows, _), (n, f) = c.shape, xx.shape
    bwd = _transposed_ell(c.cpu().numpy(), v.cpu().numpy(), n).to(device)
    adj = sparse.DifferentiableAdj(sparse.ELLAdj(c, v, n_rows=rows, n_cols=n, row_block=1), bwd)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(rows, f))
                         .astype(np.float32)).to(device)
    x = xx.detach().requires_grad_()
    before = ell_spmm.launches
    adj.spmm(x).backward(g)
    if device.type == "cuda":
        torch.cuda.synchronize()
        assert ell_spmm.launches == before + 2  # the forward and the backward
    x_plain = xx.detach().clone().requires_grad_()
    ell_spmm_plain(c, v, x_plain).backward(g)
    mag = ell_spmm_plain(bwd.cols, bwd.vals.abs(), g.abs())[:n]
    tol = 2.0 * (bwd.width + 1) * UNIT_ROUNDOFF * mag + 1e-30
    diff = (x.grad - x_plain.grad).abs()
    assert bool((diff <= tol).all()), float(diff.max())


@pytest.mark.parametrize("case", ELL_CASES, ids=_ell_id)
def test_ell_function_gradient_plain(case):
    _ell_grad_check(case, torch.device("cpu"))


# at full size the headline pack only: a skewed graph's transposed ELL pack is as wide as its
# longest column (the port takes the hybrid there, whose test follows)
@pytest.mark.cuda
@pytest.mark.parametrize("case", ELL_CASES + ["headline"], ids=_ell_id)
def test_ell_function_gradient_kernel(cuda_device, case):
    _ell_grad_check(case, cuda_device)


def _hybrid_grad_check(r, f, device, graph="powerlaw"):
    """The naive path's hybrid adjacency of ``sym_norm(r)`` on a power-law
    graph of 3,000 nodes (hub rows give each pack a tail) or, ``graph="train"``,
    on the SBM at ogbn-arxiv's size that the GCN trains on: the pack of A^T is the
    forward pack itself exactly when A is symmetric (r = 0.5), and x's
    gradient equals autograd through ``ell_spmm_plain`` and the tail's
    ``index_add``, within ``2 (c + 1) u (|A|^T |g|)``, c the most nonzeros
    of a row or column."""
    from ssrg_torch.data.synthetic import planetoid_like, powerlaw_graph
    from ssrg_torch.ops.normalize import sym_norm

    if graph == "train":
        g0 = planetoid_like(**card.TRAIN_GRAPH)
    else:
        g0 = powerlaw_graph(3000, 8.0, 4, seed=0)
    adj = sym_norm(g0.adj, r)
    n = adj.shape[0]
    dadj = sparse.differentiable_adjacency(adj, "hybrid", device=device)
    assert dadj.symmetric == (r == 0.5) == ((adj != adj.T).nnz == 0)
    assert int((dadj.fwd.tail.val != 0).sum()) > 0
    rng = np.random.default_rng(2)
    x0 = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(device)
    x = x0.clone().requires_grad_()
    before, before_coo = ell_spmm.launches, coo_accumulate.launches
    dadj.spmm(x).backward(g)
    if device.type == "cuda":
        torch.cuda.synchronize()
        assert ell_spmm.launches == before + 2
        assert coo_accumulate.launches == before_coo + 2
    x_plain = x0.clone().requires_grad_()
    fwd, tail = dadj.fwd.ell, dadj.fwd.tail
    out = ell_spmm_plain(fwd.cols, fwd.vals, x_plain)[:n]
    out.index_add(0, tail.row, x_plain.index_select(0, tail.col) * tail.val[:, None]).backward(g)
    counts = max(np.diff(adj.tocsr().indptr).max(), np.diff(adj.tocsc().indptr).max())
    mag = torch.from_numpy((abs(adj).T @ np.abs(g.cpu().numpy().astype(np.float64)))
                           .astype(np.float32)).to(device)
    tol = 2.0 * (counts + 1) * UNIT_ROUNDOFF * mag + 1e-30
    diff = (x.grad - x_plain.grad).abs()
    assert bool((diff <= tol).all()), float(diff.max())


@pytest.mark.parametrize("r", [0.5, 0.3], ids=["symmetric", "asymmetric"])
@pytest.mark.parametrize("f", [40, 256])
def test_hybrid_function_gradient_plain(r, f):
    _hybrid_grad_check(r, f, torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["powerlaw", "train"])
@pytest.mark.parametrize("r", [0.5, 0.3], ids=["symmetric", "asymmetric"])
@pytest.mark.parametrize("f", [40, 256])
def test_hybrid_function_gradient_kernel(cuda_device, r, f, graph):
    _hybrid_grad_check(r, f, cuda_device, graph)


def _phi_grad_check(f, device):
    """The wavelet basis Φ of a 600-node SBM (thresholded heat kernel, rows
    L1-normalized: positive, not symmetric, rows of many lengths) under
    autograd through the hybrid engine: the backward runs on the host-built
    pack of Φ^T. x's gradient against float64 ``Φ^T g`` (1e-5) and against
    autograd through ``ell_spmm_plain`` and the tail's ``index_add``, within
    ``2 (c + 1) u (Φ^T |g|)``, c the most nonzeros of a row or column."""
    from ssrg_torch.configs.config import WaveletConfig
    from ssrg_torch.data.synthetic import sbm_graph
    from ssrg_torch.models.wavelet import calculate_wavelets

    adj = sbm_graph(600, 3, 4, p_in=0.02, p_out=0.002, seed=3).adj
    phi = calculate_wavelets(adj, WaveletConfig(), "dense", verbose=False, device="cpu")[0]
    assert (phi != phi.T).nnz > 0 and (phi.data > 0).all()
    dadj = sparse.differentiable_adjacency(phi, "hybrid", device=device)
    assert not dadj.symmetric and int((dadj.fwd.tail.val != 0).sum()) > 0
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(rng.normal(size=(600, f)).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.normal(size=(600, f)).astype(np.float32)).to(device)
    x = x0.clone().requires_grad_()
    before = ell_spmm.launches
    dadj.spmm(x).backward(g)
    if device.type == "cuda":
        torch.cuda.synchronize()
        assert ell_spmm.launches == before + 2
    dense = phi.toarray().astype(np.float64)
    np.testing.assert_allclose(x.grad.cpu().numpy(), dense.T @ g.cpu().numpy(), rtol=1e-5,
                               atol=1e-5)
    x_plain = x0.clone().requires_grad_()
    fwd, tail = dadj.fwd.ell, dadj.fwd.tail
    out = ell_spmm_plain(fwd.cols, fwd.vals, x_plain)[:600]
    out.index_add(0, tail.row, x_plain.index_select(0, tail.col) * tail.val[:, None]).backward(g)
    counts = max(np.diff(phi.indptr).max(), np.diff(phi.tocsc().indptr).max())
    mag = torch.from_numpy((dense.T @ np.abs(g.cpu().numpy())).astype(np.float32)).to(device)
    diff = (x.grad - x_plain.grad).abs()
    assert bool((diff <= 2.0 * (counts + 1) * UNIT_ROUNDOFF * mag + 1e-30).all()), \
        float(diff.max())


@pytest.mark.parametrize("f", [3, 256])
def test_phi_function_gradient_plain(f):
    _phi_grad_check(f, torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [3, 256])
def test_phi_function_gradient_kernel(cuda_device, f):
    _phi_grad_check(f, cuda_device)


def test_kernels_refuse_to_run_under_autograd():
    """A kernel's output written through a raw pointer has no grad_fn: asked
    for a gradient, each wrapper raises (here on the CPU too), and runs as
    before under ``torch.no_grad``."""
    from ssrg_torch.ops.pallas_spmm import build_pallas_csr

    blocks, los, x, _ = _banded_case(*BANDED_CASES[0])
    for args in ((blocks, los, x.clone().requires_grad_()),
                 (blocks.clone().requires_grad_(), los, x)):
        with pytest.raises(RuntimeError, match="forward-only"):
            banded_spmm(*args)
        with torch.no_grad():
            banded_spmm(*args)
    pack, x, _ = _rest_case(*REST_CASES[0])
    rp, re_, c, v = pack.row_ptr, pack.row_end, pack.cols, pack.vals
    for args in ((rp, re_, c, v, x.clone().requires_grad_()),
                 (rp, re_, c, v.clone().requires_grad_(), x)):
        with pytest.raises(RuntimeError, match="forward-only"):
            rest_spmm(*args)
    cols, vals, xe, _ = _ell_case(16, 20, 4, 8, 0.0)
    c, v, xe = torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(xe)
    for args in ((c, v.clone().requires_grad_(), xe), (c, v, xe.clone().requires_grad_())):
        with pytest.raises(RuntimeError, match="transposed pack"):
            ell_spmm(*args)
    adj = sp.random(30, 30, 0.2, format="csr", random_state=0, dtype=np.float32)
    xg = torch.ones(30, 4, requires_grad=True)
    for built in (sparse.build_ell(adj), sparse.build_hybrid(adj)):
        with pytest.raises(RuntimeError, match="differentiable_adjacency"):
            built.spmm(xg)
    with pytest.raises(RuntimeError, match="forward only"):
        build_pallas_csr(adj).spmm(xg)
    with torch.no_grad():
        assert build_pallas_csr(adj).spmm(xg).shape == (30, 4)


@pytest.mark.cuda
def test_link_gcn_on_the_card_launches_the_kernel(cuda_device):
    """The GCN's link head on the card above ``DENSE_THRESHOLD`` (the
    hybrid engine): 4 ``ell_spmm`` launches a training epoch (2 forward, 2
    backward) and 4 an evaluation (validation and test, 2 each); its
    first epoch's loss within 1e-4 of the CPU run's (the same initial
    weights from the host generator, dropout 0)."""
    from ssrg_torch.configs.config import ModelConfig, TrainingConfig
    from ssrg_torch.data.link import link_dataset_from_graph
    from ssrg_torch.data.synthetic import planetoid_like
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.train import LinkClassification

    kw = dict(num_node=9_000, num_classes=4, num_features=16, seed=2)
    mc = ModelConfig(model_name="gcn", hidden_dim=32, dropout=0.0)
    tc = TrainingConfig(num_epochs=2, lr=1e-3)
    losses = {}
    for device in ("cpu", "cuda"):
        link = link_dataset_from_graph(planetoid_like(**kw), seed=1)
        ell_spmm.launches = 0
        task = LinkClassification(link, load_model(mc, 16, 2, link=True), mc, tc, device=device)
        losses[device] = task.history["loss"]
    assert ell_spmm.launches == 8 * tc.num_epochs
    np.testing.assert_allclose(losses["cuda"][0], losses["cpu"][0], rtol=1e-4)
