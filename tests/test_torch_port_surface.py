"""The port covers the reference's whole public surface, and the last names
it took over hold to ``ssrg_tpu``, on the CPU.

:func:`test_every_reference_name_is_ported` walks every module of
``ssrg_tpu/`` with ``ast`` and requires each public top-level function and
class in the ``ssrg_torch`` module of the same path, apart from the
differences by design in ``BY_DESIGN``. Tolerances: ``sgc_precompute``'s
hops 1e-5 (three float32 products of a 40-node dense adjacency); the
combiners 1e-6 (the same float32 means).
"""

import ast
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_FILES = sorted((ROOT / "ssrg_tpu").rglob("*.py"))
# (reference module path, name) -> why the port has no counterpart
BY_DESIGN = {
    ("data/reference_compat.py", "install_unpickle_shim"):
        "the port's ReferenceUnpickler builds the reference's pickled classes as "
        "attribute bags and installs no module shim into sys.modules",
}


def _port_module(path: pathlib.Path) -> str:
    parts = path.relative_to(ROOT / "ssrg_tpu").with_suffix("").parts
    return ".".join(("ssrg_torch",) + parts).removesuffix(".__init__")


def _public_names(path: pathlib.Path) -> list:
    tree = ast.parse(path.read_text(), filename=str(path))
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


@pytest.mark.parametrize("path", REF_FILES,
                         ids=lambda p: str(p.relative_to(ROOT / "ssrg_tpu")))
def test_every_reference_name_is_ported(path):
    rel = str(path.relative_to(ROOT / "ssrg_tpu"))
    module = importlib.import_module(_port_module(path))
    missing = [name for name in _public_names(path)
               if not hasattr(module, name) and (rel, name) not in BY_DESIGN]
    assert not missing, f"ssrg_torch/{rel} lacks {missing}"


def test_differences_by_design_are_still_differences():
    """A listed difference that the port has since gained is taken off the
    list."""
    for (rel, name), why in BY_DESIGN.items():
        assert name in _public_names(ROOT / "ssrg_tpu" / rel), (rel, name)
        module = importlib.import_module(_port_module(ROOT / "ssrg_tpu" / rel))
        assert not hasattr(module, name), f"{name} is ported now; drop it ({why})"


def test_sgc_precompute_matches_reference():
    from ssrg_tpu.bench import sgc_precompute as ref_sgc_precompute
    from ssrg_tpu.ops.sparse import build_dense as ref_build_dense

    from ssrg_torch.bench import sgc_precompute
    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.ops.sparse import device_adjacency

    rng = np.random.default_rng(0)
    a = (rng.uniform(size=(40, 40)) < 0.15).astype(np.float32)
    np.fill_diagonal(a, 0)
    adj = sym_norm(sp.csr_matrix(np.maximum(a, a.T)), 0.5)
    x = rng.normal(size=(40, 8)).astype(np.float32)
    want, ref_times = ref_sgc_precompute(ref_build_dense(adj), x, 3)
    got, times = sgc_precompute(device_adjacency(adj, "dense", device="cpu"), x, 3,
                                device="cpu")
    assert len(times) == len(ref_times) == 3 and all(t > 0 for t in times)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_combine_complex_and_multi_last_match_reference():
    from ssrg_tpu.ops import combine as ref_combine

    from ssrg_torch.ops import combine

    rng = np.random.default_rng(0)
    hops = rng.normal(size=(4, 10, 6)).astype(np.float32)
    h2 = hops * 2.0
    ref_lasts = ref_combine.combine_multi_last((jnp.asarray(hops), jnp.asarray(h2)))
    lasts = combine.combine_multi_last((torch.from_numpy(hops), torch.from_numpy(h2)))
    assert isinstance(lasts, tuple) and len(lasts) == 2
    for got, want in zip(lasts, ref_lasts):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(lasts[0].numpy() * 2, lasts[1].numpy())
    ref_pair = ref_combine.combine_complex(jnp.asarray(hops), jnp.asarray(h2),
                                           fn=ref_combine.combine_mean)
    pair = combine.combine_complex(torch.from_numpy(hops), torch.from_numpy(h2),
                                   fn=combine.combine_mean)
    for got, want in zip(pair, ref_pair):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(pair[0].numpy() * 2, pair[1].numpy(), rtol=1e-6)
    sliced = combine.combine_complex(torch.from_numpy(hops), torch.from_numpy(h2), start=1,
                                     end=3)
    np.testing.assert_array_equal(sliced[0].numpy(), hops[2])


def test_seed_everything_lives_where_the_reference_has_it():
    from ssrg_tpu.utils import seed_everything as ref_seed_everything

    from ssrg_torch.train.common import seed_everything as common_seed_everything
    from ssrg_torch.utils import seed_everything

    assert common_seed_everything is seed_everything
    ref_seed_everything(11)
    want = np.random.uniform(size=3)
    gen = seed_everything(11)
    np.testing.assert_array_equal(np.random.uniform(size=3), want)
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 11


def test_edge_softmax_lives_where_the_reference_has_it():
    from ssrg_tpu.models import baselines as ref_baselines

    from ssrg_torch.models import baselines
    from ssrg_torch.ops import sddmm

    assert baselines.edge_softmax is sddmm.edge_softmax
    rng = np.random.default_rng(3)
    scores = rng.normal(size=(12, 2)).astype(np.float32)
    row = rng.integers(0, 5, size=12).astype(np.int32)
    mask = (rng.uniform(size=12) < 0.8).astype(np.float32)
    want = ref_baselines.edge_softmax(jnp.asarray(scores), jnp.asarray(row),
                                      jnp.asarray(mask), 5)
    got = baselines.edge_softmax(torch.from_numpy(scores), torch.from_numpy(row),
                                 torch.from_numpy(mask), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
