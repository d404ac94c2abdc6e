"""A run with the timed path broken underneath comes out not correct.

The harness runs on the CPU at a small size (``tiny``) with its look for a
card skipped, the cell's own limits in force. A sound run is correct;
each fault that the cell can have, planted in the program, makes it not
correct: a step that leaves its state unchanged (train), half of the
batch left out with the mean taken over the rest, an answer altered where
it is produced. (The exchange between chips is not a fault of a one-chip
cell.)
"""

import pytest
import torch

from benchmark.tests.tiny import run_tiny, tiny_cell

EVAL = ['nl50-eval-bf16', 'sf50-eval-bf16']
TRAIN = ['nl50-finetune-f32', 'nl50-train-bf16']


def _half_batch_metrics(monkeypatch):
    from pretorched_tpu_torch.parallel import evaluate
    whole = evaluate._masked_metrics

    def half(logits, labels, topk):
        n = len(labels) // 2
        return {k: 2 * v for k, v in whole(logits[:n], labels[:n],
                                           topk).items()}
    monkeypatch.setattr(evaluate, '_masked_metrics', half)


def _altered_logit(monkeypatch):
    from pretorched_tpu_torch.core.wrapper import PretrainedModel
    forward = PretrainedModel.forward

    def altered(self, x):
        out = forward(self, x)
        flip = torch.zeros_like(out)
        flip[0, 0] = out[0].max() - out[0, 0] + 1.0    # class 0 now first
        return out + flip
    monkeypatch.setattr(PretrainedModel, 'forward', altered)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, 'step', lambda self, closure=None:
                        None)


def _half_batch_loss(monkeypatch):
    from pretorched_tpu_torch.parallel import train
    whole = train.cross_entropy

    def half(logits, labels):
        n = len(labels) // 2
        return whole(logits[:n], labels[:n])
    monkeypatch.setattr(train, 'cross_entropy', half)


def _altered_label(monkeypatch):
    from pretorched_tpu_torch.parallel import train
    whole = train.cross_entropy
    monkeypatch.setattr(train, 'cross_entropy', lambda logits, labels:
                        whole(logits, labels.roll(1)))


@pytest.mark.parametrize('name', EVAL + TRAIN)
def test_sound_run_is_correct(name):
    result, _ = run_tiny(tiny_cell(name, 'float64' if name in TRAIN
                                   else 'float32'))
    assert result['correct'], result['compared']


@pytest.mark.parametrize('name', EVAL)
@pytest.mark.parametrize('fault', [_half_batch_metrics, _altered_logit])
def test_eval_fault(name, fault, monkeypatch):
    fault(monkeypatch)
    result, _ = run_tiny(tiny_cell(name))
    assert not result['correct']


@pytest.mark.parametrize('name', TRAIN)
@pytest.mark.parametrize('fault', [_state_unchanged, _half_batch_loss,
                                   _altered_label])
def test_train_fault(name, fault, monkeypatch):
    fault(monkeypatch)
    result, _ = run_tiny(tiny_cell(name, 'float64'))
    assert not result['correct']
