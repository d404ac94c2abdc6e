"""One rank of the two-process Gloo run of ``tests/test_torch_parallel.py``.

    python tests/torch_dist_worker.py RANK PORT WORKDIR

Imports no JAX. Reads ``WORKDIR/inputs.pt`` (the small ResNet's weights,
carried from the JAX package by the test, and the seeded batches), joins
the other rank through ``parallel.dist.initialize`` (Gloo on
``127.0.0.1:PORT``) and writes what it measured to
``WORKDIR/result_RANK.pt``:

* ``eval``: the metric sums of the ragged 13-image batch, padded to the
  data axis and split by ``global_batch``, on a (2, 1) mesh;
* ``dp``, ``dp_accum``: 2 data-parallel train steps (global batch norm,
  gradients averaged over 'data'), with ``accum_steps`` 1 and 2; ``zero1``,
  ``zero1_accum``, ``fsdp``, ``fsdp_accum``: the same through
  ``zero_init`` (losses, rank 0's full state dict, this rank's optimizer
  bytes);
* ``fsdp_load``: the eval logits of an FSDP model loaded from the whole
  state dict against the plain model's;
* ``tp100``, ``tp101``: ``resnet18`` heads of 100 and 101 classes placed
  on a (1, 2) mesh: the head's placement and local shape, and the logits
  against the unplaced model's;
* ``cli_1``, ``cli_fsdp``: ``examples/imagenet_eval_torch.py`` training
  ``resnet18`` for an epoch on ``WORKDIR/images`` with ``--zero`` and
  ``--zero fsdp``, each rank in a directory of its own: its train steps,
  the validation totals and whether it wrote a checkpoint.
"""

import importlib.util
import os
import sys

import torch

RANK, PORT, WORK = int(sys.argv[1]), sys.argv[2], os.path.abspath(sys.argv[3])
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import pretorched_tpu_torch as pretorched  # noqa: E402
from pretorched_tpu_torch.models.resnet import ResNet  # noqa: E402
from pretorched_tpu_torch.parallel import dist  # noqa: E402
from pretorched_tpu_torch.parallel.evaluate import (  # noqa: E402
    pad_batch, sharded_accuracy_step)
from pretorched_tpu_torch.parallel.mesh import (  # noqa: E402
    global_batch, make_mesh, model_shardings, place_model)
from pretorched_tpu_torch.parallel.train import make_train_step  # noqa: E402
from pretorched_tpu_torch.parallel.zero import (  # noqa: E402
    full_state_dicts, load_full_state_dict, sharded_size_bytes, zero_init)

WIDTHS, CLASSES, LR, STEPS = (8, 16, 32, 64), 5, 0.05, 2


def small(state):
    model = ResNet('basic', (1, 1, 1, 1), num_classes=CLASSES,
                   width_per_stage=WIDTHS)
    model.load_state_dict(state)
    return model


def train(inp, mesh, zero=None, accum=1):
    model = small(inp['state'])
    if zero is None:
        place_model(model, mesh)
        opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
    else:
        model, opt = zero_init(model, torch.optim.SGD, mesh,
                               shard_params=zero == 'fsdp', lr=LR,
                               momentum=0.9)
    step = make_train_step(model, opt, mesh=mesh, accum_steps=accum,
                           zero_axis=None if zero is None else 'data',
                           zero_params=zero == 'fsdp')
    x = global_batch(mesh, inp['x_train'])
    y = global_batch(mesh, inp['y_train'])
    losses = [float(step(x, y)['loss']) for _ in range(STEPS)]
    opt_bytes = sharded_size_bytes(opt)
    state, _ = full_state_dicts(model, opt)
    return {'losses': losses, 'state': state, 'opt_bytes': opt_bytes}


def main():
    assert dist.initialize(f'127.0.0.1:{PORT}', 2, RANK, backend='gloo')
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(WORK, 'inputs.pt'), weights_only=True)
    mesh = make_mesh((2, 1), device_type='cpu')
    res = {}

    model = small(inp['state']).eval()
    place_model(model, mesh)
    x, y = pad_batch(inp['x_eval'], inp['y_eval'].numpy(), 2)
    out = sharded_accuracy_step(model, mesh=mesh)(
        global_batch(mesh, x), torch.from_numpy(global_batch(mesh, y)))
    res['eval'] = {k: v.item() for k, v in out.items()}

    for name, zero, accum in (('dp', None, 1), ('dp_accum', None, 2),
                              ('zero1', '1', 1), ('zero1_accum', '1', 2),
                              ('fsdp', 'fsdp', 1), ('fsdp_accum', 'fsdp', 2)):
        res[name] = train(inp, mesh, zero, accum)

    sharded, _ = zero_init(small(inp['state']), torch.optim.SGD, mesh,
                           shard_params=True, lr=LR)
    load_full_state_dict(sharded, inp['state'])
    with torch.no_grad():
        got = sharded.eval()(inp['x_train'])
        want = small(inp['state']).eval()(inp['x_train'])
    res['fsdp_load'] = (got - want).abs().max().item()

    mesh_tp = make_mesh((1, 2), device_type='cpu')
    for classes in (100, 101):
        torch.manual_seed(classes)
        model = pretorched.resnet18(num_classes=classes,
                                    pretrained=None).eval()
        with torch.no_grad():
            want = model(inp['x_train'])
            placement = str(model_shardings(mesh_tp, model)
                            ['last_linear.weight'])
            place_model(model, mesh_tp)
            got = model(inp['x_train'])
        weight = model.last_linear.weight
        res[f'tp{classes}'] = {
            'placement': placement,
            'dtensor': hasattr(weight, 'to_local'),
            'local_shape': tuple(getattr(weight, 'to_local',
                                         lambda: weight)().shape),
            'logits_shape': tuple(got.shape),
            'max_diff': (got - want).abs().max().item()}

    spec = importlib.util.spec_from_file_location(
        'imagenet_eval_torch', os.path.join(REPO, 'examples',
                                            'imagenet_eval_torch.py'))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    for zero in ('1', 'fsdp'):
        run_dir = os.path.join(WORK, f'cli_{zero}_{RANK}')
        os.makedirs(run_dir)
        os.chdir(run_dir)
        summary = cli.main([os.path.join(WORK, 'images'), '-a', 'resnet18',
                            '--pretrained', 'none', '-b', '2', '--epochs',
                            '1', '--device', 'cpu', '-j', '1', '--zero',
                            zero])
        res[f'cli_{zero}'] = {
            'train_steps': summary['train_steps'],
            'totals': {k: float(v) for k, v in summary['totals'].items()},
            'checkpoint': os.path.exists('checkpoint.pth')}
        os.chdir(WORK)

    torch.save(res, os.path.join(WORK, f'result_{RANK}.pt'))
    torch.distributed.destroy_process_group()
    print(f'TORCH-DIST-OK rank={RANK}', flush=True)


if __name__ == '__main__':
    main()
