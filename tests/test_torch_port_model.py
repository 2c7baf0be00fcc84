"""Parity of the PyTorch port's message operators, heads, model zoo,
``prepare`` and ``Predictor`` with ``ssrg_tpu``, on the CPU.

The flax modules are initialized in JAX, their parameters carried over by
``ssrg_torch.convert.params_from_jax``, and both forwards run on the same
numpy inputs. Message ops and heads agree at 1e-5; ``prepare`` inputs and
``Predictor`` logits at 1e-4 (K = 3 hops of float32 sums in another order).
"""

import jax
import numpy as np
import pytest
import torch

from ssrg_tpu.configs.config import ModelConfig as RefModelConfig
from ssrg_tpu.configs.config import TrainingConfig as RefTrainingConfig
from ssrg_tpu.data.synthetic import planetoid_like as ref_planetoid_like
from ssrg_tpu.models import heads as ref_heads
from ssrg_tpu.models.zoo import load_model as ref_load_model
from ssrg_tpu.ops import combine as ref_combine
from ssrg_tpu.serve import Predictor as RefPredictor

from ssrg_torch.configs.config import ModelConfig, TrainingConfig
from ssrg_torch.convert import params_from_jax
from ssrg_torch.data.synthetic import planetoid_like
from ssrg_torch.models import heads
from ssrg_torch.models.zoo import MODEL_REGISTRY, ModelSpec, load_model
from ssrg_torch.ops import combine
from ssrg_torch.ops.sparse import DenseAdj
from ssrg_torch.serve import Predictor
from ssrg_torch.train.node_classification import prepare

CPU = "cpu"
K, N, F = 3, 37, 12


@pytest.fixture(scope="module")
def hops():
    return np.random.default_rng(0).normal(size=(K + 1, N, F)).astype(np.float32)


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_node=800, num_classes=4, num_features=48, seed=0)
    return ref_planetoid_like(**kw), planetoid_like(**kw)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def _flax_forward(module, x, **kwargs):
    variables = module.init(jax.random.PRNGKey(1), x, **kwargs)
    params = jax.tree_util.tree_map(np.asarray, variables.get("params", {}))
    return np.asarray(module.apply(variables, x, **kwargs)), params


def _torch_forward(module, params, x):
    module.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        return module.eval()(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("kind", ["last", "sum", "mean", "max", "min", "concat", "over_smooth"])
@pytest.mark.parametrize("span", [(None, None), (1, None), (0, 3)])
def test_simple_combiners(hops, kind, span):
    ref, _ = _flax_forward(ref_combine.SimpleMessageOp(kind=kind, start=span[0], end=span[1]),
                           hops)
    got = combine.SimpleMessageOp(kind, *span)(torch.from_numpy(hops)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kwargs", [
    dict(combination_type="alpha", alpha=0.5),
    dict(combination_type="alpha", alpha=0.2, start=1),
    dict(combination_type="hand_crafted", weight_list=[0.1, 0.2, 0.3, 0.4], end=3),
])
def test_simple_weighted(hops, kwargs):
    ref, _ = _flax_forward(ref_combine.make_message_op("simple_weighted", **kwargs), hops)
    got = combine.make_message_op("simple_weighted", **kwargs)(torch.from_numpy(hops))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ct", ["simple", "simple_allow_neg", "gate", "ori_ref", "jk"])
@pytest.mark.parametrize("span", [(None, None), (1, None)])
def test_learnable_weighted(hops, ct, span):
    kw = dict(combination_type=ct, prop_steps=K, feat_dim=F, start=span[0], end=span[1])
    ref, params = _flax_forward(ref_combine.LearnableWeightedMessageOp(**kw), hops)
    got = _torch_forward(combine.LearnableWeightedMessageOp(**kw), params, hops)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_iterate_learnable_weighted(hops):
    ref, params = _flax_forward(ref_combine.IterateLearnableWeightedMessageOp(), hops)
    got = _torch_forward(combine.IterateLearnableWeightedMessageOp(feat_dim=F), params, hops)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_projected_concat(hops):
    ref, params = _flax_forward(
        ref_combine.ProjectedConcatMessageOp(hidden_dim=16, num_layers=2), hops)
    op = combine.ProjectedConcatMessageOp(hidden_dim=16, num_layers=2, feat_dim=F,
                                          prop_steps=K)
    assert op.out_dim == ref.shape[1]
    np.testing.assert_allclose(_torch_forward(op, params, hops), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_layers", [2, 3])
def test_heads(hops, num_layers):
    x = hops[0]
    ref, params = _flax_forward(ref_heads.LogisticRegression(output_dim=5), x)
    got = _torch_forward(heads.LogisticRegression(F, 5), params, x)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    ref, params = _flax_forward(
        ref_heads.MultiLayerPerceptron(hidden_dim=32, output_dim=5, num_layers=num_layers), x)
    assert float(params[f"prelu_{num_layers - 2}"]["slope"]) == 0.25
    got = _torch_forward(heads.MultiLayerPerceptron(F, 32, 5, num_layers=num_layers),
                         params, x)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["sgc", "ssgc", "sign", "gbp", "gamlp", "nafs"])
def test_state_dict_names_match_flax_params(hops, name):
    """The converted flax tree of every ported model fills the torch model
    exactly: same names, same shapes."""
    ref_spec = ref_load_model(RefModelConfig(model_name=name, hidden_dim=16), F, 4)
    spec = load_model(ModelConfig(model_name=name, hidden_dim=16), F, 4)
    inputs = hops if spec.pre_msg_learnable else hops[-1]
    module = ref_spec.module if spec.pre_msg_learnable else ref_spec.module.clone(msg_op=None)
    params = module.init(jax.random.PRNGKey(0), inputs)["params"]
    converted = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    ours = (spec.module if spec.pre_msg_learnable
            else type(spec.module)(None, spec.module.head)).state_dict()
    assert {k: tuple(v.shape) for k, v in converted.items()} == \
        {k: tuple(v.shape) for k, v in ours.items()}


def test_reset_parameters_follows_the_generator():
    spec = load_model(ModelConfig(model_name="gamlp", hidden_dim=16), F, 4)
    states = []
    for _ in range(2):
        spec.module.reset_parameters(torch.Generator().manual_seed(7))
        states.append({k: v.clone() for k, v in spec.module.state_dict().items()})
    for k in states[0]:
        torch.testing.assert_close(states[0][k], states[1][k], rtol=0, atol=0)
    w = states[0]["head.fc_0.weight"]
    # xavier-uniform with the relu gain: variance 2 / fan_avg, limit sqrt(3 * variance)
    limit = (3.0 * 2.0 / ((w.shape[0] + w.shape[1]) / 2)) ** 0.5
    assert float(w.abs().max()) <= limit and float(w.std()) > 0.5 * limit / 3 ** 0.5
    assert float(states[0]["head.prelu_0.slope"]) == 0.25


@pytest.mark.parametrize("engine", ["auto", "hybrid", "pallas"])
@pytest.mark.parametrize("name", ["sgc", "gbp", "gamlp"])
def test_predictor_matches_reference(datasets, name, engine):
    ref_ds, ds = datasets
    ref_cfg = RefModelConfig(model_name=name, hidden_dim=64)
    ref = RefPredictor(ref_ds, ref_load_model(ref_cfg, 48, 4), ref_cfg,
                       RefTrainingConfig(spmm_engine=engine))
    cfg = ModelConfig(model_name=name, hidden_dim=64)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params))
    got = Predictor(ds, load_model(cfg, 48, 4), cfg, TrainingConfig(spmm_engine=engine),
                    params=params, device=CPU)
    assert got.prepared.hops_layout == ref.prepared.hops_layout
    np.testing.assert_allclose(got.prepared.inputs.numpy(),
                               np.asarray(ref.prepared.inputs), rtol=1e-4, atol=1e-4)
    ids = np.concatenate([ds.test_idx, [0, 799]])
    logits = got.logits(ids)
    np.testing.assert_allclose(logits.numpy(), ref.logits(ids), rtol=1e-4, atol=1e-4)
    assert torch.equal(got.predict(ids), logits.argmax(dim=-1))
    np.testing.assert_allclose(got.predict_proba(ids).sum(dim=-1).numpy(), 1.0, rtol=1e-5)
    # a state dict of the port's own model loads the same way
    again = Predictor(ds, load_model(cfg, 48, 4), cfg, TrainingConfig(spmm_engine=engine),
                      params=got.module.state_dict(), device=CPU)
    assert torch.equal(again.logits(ids), logits)


def test_predictor_rejects_out_of_range_ids(datasets):
    _, ds = datasets
    cfg = ModelConfig(model_name="sgc")
    pred = Predictor(ds, load_model(cfg, 48, 4), cfg, device=CPU)
    with pytest.raises(IndexError):
        pred.logits([0, 800])


def test_unported_paths_raise(datasets):
    """Every registry model builds and every graph op runs through
    ``prepare``; the bench's sharded tier, the last path that raised
    ``NotImplementedError``, runs (on a world of one rank it starts and
    ends); ``query_edges`` given to a node head (built without ``link``) is
    a ``ValueError``; a config passed for a spec is a ``TypeError``."""
    from ssrg_torch import bench
    from ssrg_torch.models.zoo import GRAPH_OPS

    _, ds = datasets
    assert len(MODEL_REGISTRY) == 12 and len(GRAPH_OPS) == 7
    for name in MODEL_REGISTRY:
        spec = load_model(ModelConfig(model_name=name, hidden_dim=8), 48, 4)
        assert spec.name == name
    spec = load_model(ModelConfig(model_name="sgc"), 48, 4)
    for op in GRAPH_OPS:
        other = ModelSpec(name="x", graph_op=op, module=spec.module, prop_steps=2)
        inputs = prepare(other, ds, ModelConfig(), TrainingConfig(), device=CPU).inputs
        for part in inputs if isinstance(inputs, tuple) else (inputs,):
            assert part.shape[-2] == 800 and bool(torch.isfinite(part).all()), op
    wavelet = load_model(ModelConfig(model_name="wavelet", hidden_dim=8), 48, 4).module.head
    wavelet.set_num_nodes(3)
    eye = DenseAdj(torch.eye(3))
    with pytest.raises(ValueError, match="query_edges"):
        wavelet(torch.ones(3, 48), (eye, eye), query_edges=torch.zeros(1, 2, dtype=torch.long))
    from ssrg_torch.ops.normalize import sym_norm

    sharded = bench.sharded_tier_metrics(sym_norm(ds.adj, 0.5), 4, 2, iters=1, device=CPU)
    assert sharded["sharded_edges_per_s"] > 0 and not torch.distributed.is_initialized()
    with pytest.raises(TypeError):
        prepare(ModelConfig(), ds, ModelConfig(), TrainingConfig(), device=CPU)


def test_prepare_and_predictor_default_to_cuda(datasets, no_cuda):
    _, ds = datasets
    cfg = ModelConfig(model_name="gamlp")
    spec = load_model(cfg, 48, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        prepare(spec, ds, cfg, TrainingConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor(ds, spec, cfg)
