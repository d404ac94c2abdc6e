"""One rank of the four-process Gloo run of ``tests/test_torch_seq.py``.

    python tests/torch_dist_seq_worker.py RANK PORT WORKDIR

Imports no JAX. Reads ``WORKDIR/inputs.pt`` (the small models' weights,
the clips and the labels, written by the test), joins the other ranks
through ``parallel.dist.initialize`` (Gloo on ``127.0.0.1:PORT``) and
writes what it measured to ``WORKDIR/result_RANK.pt``:

* ``seq``: for each ('data', 'seq', 'model') mesh of ``MESHES``, each
  model and each clip length of ``FRAMES`` (and ``LONG`` on
  ``LONG_MESHES``), one f64 train step (SGD, lr 1e-3) of the model placed
  (``mesh.place_model``) and time-sharded (``seq.seq_parallel``) through
  ``make_train_step(..., mesh=mesh)`` on this rank's rows and frames,
  beside the same step in one process on the whole batch: both losses,
  each parameter's gradient difference (a DTensor's gathered whole; its
  norm) and gradient norm, a fingerprint of each gradient (its sum, its
  sum of squares and a weighted sum) for the ranks to be compared, and
  whether the activations ended whole (a short-shard gather) or sharded;
* ``remat``: the (1, 2, 2) step of the non-local model at 8 frames with
  ``remat=True``, so; ``stage_slice``: the refusal of a stage slice;
  ``uninstalled``: the refusal of a train step on that mesh for a model
  without the time-sharding rules;
* ``seq_jax``: one such step (SGD momentum 0.9, lr 1e-3) of each model
  on the (2, 2, 1) mesh at 8 frames: the loss and, on rank 0, each
  tensor's change (f32);
* ``tp``: two steps of the dry run's VideoResNet on ('data', 'model') =
  (2, 2) with its head column-sharded (``mesh.place_model``; SGD with
  momentum 0.9, weight decay 1e-4, lr 1e-3): the losses, the head's
  placement and local
  shape, and rank 0's state through ``zero.full_state_dicts`` (its keys,
  the head's shape and each tensor's change, f32); then the round trip:
  both dicts loaded on every rank into a fresh placed model and optimizer,
  one more step of each, and the two states compared.

Whole gradients and states of these models take 110 MB each in f64, so
the results hold differences and changes, not the tensors.
"""

import os
import sys

import torch

RANK, PORT, WORK = int(sys.argv[1]), sys.argv[2], os.path.abspath(sys.argv[3])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pretorched_tpu_torch.models.nonlocalnet import NonLocalResNet3D  # noqa: E402
from pretorched_tpu_torch.models.resnet3d import VideoResNet  # noqa: E402
from pretorched_tpu_torch.parallel import dist  # noqa: E402
from pretorched_tpu_torch.parallel.mesh import (  # noqa: E402
    axis_size, global_batch, make_mesh, place_model)
from pretorched_tpu_torch.parallel.seq import seq_parallel  # noqa: E402
from pretorched_tpu_torch.parallel.train import (  # noqa: E402
    make_train_step, sgd_step_decay)
from pretorched_tpu_torch.parallel.zero import (  # noqa: E402
    full_state_dicts, load_full_state_dict, load_optimizer_state)

AXES = ('data', 'seq', 'model')
MESHES = ((1, 2, 2), (2, 2, 1), (1, 4, 1))
FRAMES = (8, 16)
# at 32 frames and S = 2 every op runs on its shard (layer 4 on 1 frame):
# the head pool sums the shards' features over 'seq'
LONG, LONG_MESHES = 32, ((1, 2, 2), (2, 2, 1))
LR = 1e-3


def build(spec, state):
    cls = {'VideoResNet': VideoResNet,
           'NonLocalResNet3D': NonLocalResNet3D}[spec['cls']]
    model = cls(**spec['kw'])
    model.load_state_dict(state)
    return model.double()


def placed(spec, state, mesh):
    """The model placed on ``mesh``, time-sharded where 'seq' > 1."""
    model = place_model(build(spec, state), mesh)
    return seq_parallel(model, mesh) if axis_size(mesh, 'seq') > 1 else model


def whole(t):
    return t.full_tensor() if hasattr(t, 'full_tensor') else t


def fingerprint(g):
    g = g.detach().double().flatten()
    return torch.stack([g.sum(), g.square().sum(),
                        g @ torch.linspace(-1, 1, len(g), dtype=g.dtype)])


def grads_of(model, opt, step, x, y):
    out = step(x, y)
    return out['loss'].item(), {n: whole(p.grad).detach()
                                for n, p in model.named_parameters()}


REFERENCE = {}


def reference(inp, name, frames):
    """The one-process step on the whole batch: (loss, gradients)."""
    if (name, frames) not in REFERENCE:
        model = build(*inp['models'][name])
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        REFERENCE[name, frames] = grads_of(
            model, opt, make_train_step(model, opt),
            inp['clips'][frames].double(), inp['labels'])
    return REFERENCE[name, frames]


def one_step(inp, name, frames, mesh, remat=False):
    model = placed(*inp['models'][name], mesh)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    step = make_train_step(model, opt, mesh=mesh, remat=remat)
    x = global_batch(mesh, inp['clips'][frames].double())
    loss, grads = grads_of(model, opt, step, x,
                           global_batch(mesh, inp['labels']))
    ref_loss, ref = reference(inp, name, frames)
    return {'loss': loss, 'ref_loss': ref_loss, 'frames': tuple(x.shape),
            'whole': model.seq.whole,
            'diff': {n: (g - ref[n]).norm().item() for n, g in grads.items()},
            'norm': {n: g.norm().item() for n, g in ref.items()},
            'fingerprint': {n: fingerprint(g) for n, g in grads.items()}}


def changes(state, start):
    return {k: (v.double() - start[k].double()).float()
            for k, v in state.items()}


def steps(model, opt, sched, mesh, x, y, n):
    step = make_train_step(model, opt, sched, mesh=mesh)
    return [step(global_batch(mesh, x), global_batch(mesh, y))['loss'].item()
            for _ in range(n)]


def main():
    assert dist.initialize(f'127.0.0.1:{PORT}', 4, RANK, backend='gloo')
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(WORK, 'inputs.pt'), weights_only=False)
    res = {'seq': {}, 'seq_jax': {}}

    for shape in MESHES:
        mesh = make_mesh(shape, AXES, device_type='cpu')
        lengths = FRAMES + ((LONG,) if shape in LONG_MESHES else ())
        for name in inp['models']:
            for frames in lengths:
                res['seq'][shape, name, frames] = one_step(inp, name, frames,
                                                           mesh)
        if shape == (2, 2, 1):
            for name, (spec, state) in inp['models'].items():
                model = placed(spec, state, mesh)
                opt = torch.optim.SGD(model.parameters(), lr=LR,
                                      momentum=0.9)
                losses = steps(model, opt, None, mesh,
                               inp['clips'][8].double(), inp['labels'], 1)
                res['seq_jax'][name] = {
                    'losses': losses,
                    'moved': changes(model.state_dict(), state)
                    if RANK == 0 else {}}
        if shape == (1, 2, 2):
            res['remat'] = one_step(inp, 'NonLocalResNet3D', 8, mesh,
                                    remat=True)
            model = seq_parallel(build(*inp['models']['VideoResNet']), mesh)
            try:
                model(global_batch(mesh, inp['clips'][8].double()),
                      stage_slice=(0, 2))
                res['stage_slice'] = None
            except ValueError as e:
                res['stage_slice'] = str(e)
            model = place_model(build(*inp['models']['VideoResNet']), mesh)
            try:
                make_train_step(model, torch.optim.SGD(model.parameters(),
                                                       lr=LR), mesh=mesh)
                res['uninstalled'] = None
            except ValueError as e:
                res['uninstalled'] = str(e)

    # the tensor-parallel head: 2 steps, then a checkpoint round trip
    mesh = make_mesh((2, 2), ('data', 'model'), device_type='cpu')
    spec, state = inp['models']['VideoResNet']
    sgd = dict(lr=LR, momentum=0.9, weight_decay=1e-4, decay_epochs=30)
    model = place_model(build(spec, state), mesh)
    opt, sched = sgd_step_decay(model.parameters(), **sgd)
    x, y = inp['clips'][8].double(), inp['labels']
    weight = model.last_linear.weight
    tp = {'losses': steps(model, opt, sched, mesh, x, y, 2),
          'placement': str(weight.placements),
          'local_shape': tuple(weight.to_local().shape)}
    msd, osd = full_state_dicts(model, opt)
    tp.update(saved_keys=sorted(msd), moved=changes(msd, state) if msd else {},
              dtensors=[k for k, v in msd.items() if hasattr(v, 'to_local')],
              head_shape=tuple(msd['last_linear.weight'].shape)
              if msd else None)
    path = os.path.join(WORK, 'tp_checkpoint.pt')
    if RANK == 0:
        torch.save({'model': msd, 'optimizer': osd}, path)
    torch.distributed.barrier()
    saved = torch.load(path, weights_only=False)
    fresh = place_model(build(spec, state), mesh)
    opt2, sched2 = sgd_step_decay(fresh.parameters(), **sgd)
    load_full_state_dict(fresh, saved['model'])
    load_optimizer_state(fresh, opt2, saved['optimizer'])
    for m, o in ((model, opt), (fresh, opt2)):
        make_train_step(m, o, mesh=mesh)(global_batch(mesh, x),
                                         global_batch(mesh, y))
    a, b = model.state_dict(), fresh.state_dict()
    tp['resumed_max_diff'] = max((whole(a[k]) - whole(b[k])).abs().max().item()
                                 for k in a)
    res['tp'] = tp

    torch.save(res, os.path.join(WORK, f'result_{RANK}.pt'))
    torch.distributed.destroy_process_group()
    print(f'TORCH-DIST-SEQ-OK rank={RANK}', flush=True)


if __name__ == '__main__':
    main()
