"""Each cell's run with its timed path broken underneath comes out not
correct: a step that leaves its state unchanged and a loss over half of the
batch (training cells), an answer altered where it is produced (the
planned ``prepare`` and serving cells). No cell runs across chips, so none can lose
an exchange between them. The runs skip the look for a card and run small
copies of the configurations on the CPU."""

import pytest
import torch

from portbench.tests import small

TRAIN = ["gcn-products-fullbatch", "gamlp-arxiv-train"]


def not_correct(workload, root=small.manifest.ROOT):
    _cell, outcome = small.execute(workload, root=root)
    return not outcome.correct


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_that_leaves_its_state_unchanged(workload, monkeypatch):
    from ssrg_torch.train import common

    apply = common.TrainState.apply_gradients

    def unchanged(state):
        before = [p.detach().clone() for p in state.module.parameters()]
        apply(state)
        with torch.no_grad():
            for p, b in zip(state.module.parameters(), before):
                p.copy_(b)

    monkeypatch.setattr(common.TrainState, "apply_gradients", unchanged)
    assert not_correct(workload)


@pytest.mark.parametrize("workload", TRAIN)
def test_half_of_the_batch_left_out(workload, monkeypatch):
    from ssrg_torch.train import baseline_task, common

    loss = common.cross_entropy_loss

    def half(logits, labels, weights=None):
        n = logits.shape[0] // 2
        return loss(logits[:n], labels[:n], None if weights is None else weights[:n])

    monkeypatch.setattr(common, "cross_entropy_loss", half)
    monkeypatch.setattr(baseline_task, "cross_entropy_loss", half)
    assert not_correct(workload)


def test_a_hop_row_altered(monkeypatch, tmp_path):
    from ssrg_torch.ops import propagate as prop

    run = prop.propagate

    def altered(*args, **kwargs):
        hops = run(*args, **kwargs)
        hops[-1, 7] += 1.0
        return hops

    monkeypatch.setattr(prop, "propagate", altered)
    assert not_correct("gamlp-arxiv-prepare", small.with_planned(tmp_path))


def test_an_answer_altered(monkeypatch, tmp_path):
    from ssrg_torch import serve

    logits = serve.Predictor.logits

    def altered(self, node_ids):
        out = logits(self, node_ids).clone()
        out[0, 0] += 1.0
        return out

    monkeypatch.setattr(serve.Predictor, "logits", altered)
    assert not_correct("gamlp-arxiv-serve", small.with_planned(tmp_path))
