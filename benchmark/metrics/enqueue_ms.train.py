"""Host ms to return from one call of the train step
(``parallel.train.make_train_step``: autograd, SGD, remat), no
synchronize inside: what the host spends to queue a step."""


def read(run):
    ms = run.host_ms.get('step')
    return sum(ms) / len(ms) if ms else None
