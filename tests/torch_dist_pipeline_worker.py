"""One rank of the two-process Gloo run of ``tests/test_torch_pipeline.py``
and ``tests/test_torch_moe.py``.

    python tests/torch_dist_pipeline_worker.py RANK PORT WORKDIR

Imports no JAX. Reads ``WORKDIR/inputs.pt`` (seeded tensors the tests
made with numpy), joins the other rank through ``parallel.dist.initialize``
(Gloo on ``127.0.0.1:PORT``) and writes what it measured to
``WORKDIR/result_RANK.pt``:

* ``pp``: ``pipeline_apply`` over a (1, 2) ('data', 'stage') mesh of L = 8
  residual conv blocks: this rank's block count, the output and the
  gradients of its blocks and of the input for the loss
  ``mean(out ** 2)``;
* ``pp_stages``: ``pipeline_apply_stages`` of a small ``VideoResNet`` in
  two stages (``stage_slice`` (0, 2) and (2, 4)) on the same mesh;
* ``dp``: ``pipeline_apply`` over a (2, 1) mesh with ``batch_axes=('data',)``,
  ``pipeline_apply_stages`` of the whole ``VideoResNet`` as one stage
  there, and each one's batch guard message at 12 rows, 2 shards and 4
  microbatches;
* ``moe``: ``moe_apply`` over a (1, 2) ('data', 'expert') mesh of E = 4
  experts: this rank's expert count, the output and the gradients of the
  router and of its experts; ``mstrn``: ``mstrn_expert_apply`` over the
  same mesh;
* ``serve``: ``mesh.sharded_apply`` of a linear map on the (2, 1) mesh,
  outside a server.
"""

import os
import sys

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pretorched_tpu_torch.models.resnet3d import VideoResNet  # noqa: E402
from pretorched_tpu_torch.models.trn import MultiScaleRelation  # noqa: E402
from pretorched_tpu_torch.parallel import dist, moe  # noqa: E402
from pretorched_tpu_torch.parallel.mesh import (make_mesh,  # noqa: E402
                                                sharded_apply)
from pretorched_tpu_torch.parallel.pipeline import (  # noqa: E402
    pipeline_apply, pipeline_apply_stages, stage_sharding)

N_MICRO = 4
MSTRN = dict(num_inputs=8, in_features=24, out_features=12, bottleneck_dim=16)


def conv(p, x):
    """A 3x3 'SAME' conv of a flax kernel (3, 3, in, out) on NCHW."""
    return F.conv2d(x, p['kernel'].permute(3, 2, 0, 1), p['bias'], padding=1)


def block_fn(p, x):
    """The shape-preserving residual conv block of
    ``tests/test_pipeline_parallel.py`` (a trunk block stand-in) on its
    flax parameters, channels-first; JAX's gelu is the tanh one."""
    h = F.gelu(conv(p['conv1'], x), approximate='tanh')
    return x + 0.5 * conv(p['conv2'], h)


def expert_fn(p, x):
    return F.gelu(x @ p['w1']) @ p['w2']


def small_video_resnet(state):
    model = VideoResNet('bottleneck', (1, 1, 1, 1), num_classes=6,
                        width_per_stage=(8, 16, 32, 64)).eval()
    model.load_state_dict(state)
    return model


def two_stage_fns(model):
    def make(lo, hi):
        return lambda state, x: torch.func.functional_call(
            model, state, (x,), {'stage_slice': (lo, hi)})
    return [make(0, 2), make(2, 4)]


def split_two(state):
    first = ('conv1', 'bn1', 'layer1', 'layer2')
    return [{k: v for k, v in state.items() if k.split('.')[0] in first},
            {k: v for k, v in state.items() if k.split('.')[0] not in first}]


def leaves(tree):
    if isinstance(tree, dict):
        return {k: leaves(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_()


def grads(tree):
    if isinstance(tree, dict):
        return {k: grads(v) for k, v in tree.items()}
    return tree.grad


def main():
    assert dist.initialize(f'127.0.0.1:{PORT}', 2, RANK, backend='gloo')
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(WORK, 'inputs.pt'), weights_only=True)
    res = {}

    mesh_pp = make_mesh((1, 2), ('data', 'stage'), device_type='cpu')
    local = stage_sharding(mesh_pp, leaves(inp['blocks']))
    x = inp['x'].clone().requires_grad_()
    out = pipeline_apply(block_fn, local, x, mesh_pp, n_micro=N_MICRO)
    (out ** 2).mean().backward()
    res['pp'] = {'blocks': local['conv1']['kernel'].shape[0],
                 'total': local.total, 'out': out.detach(),
                 'grads': grads(local), 'x_grad': x.grad}

    model = small_video_resnet(inp['video_state'])
    out = pipeline_apply_stages(two_stage_fns(model),
                                split_two(model.state_dict()),
                                inp['clips'], mesh_pp, n_micro=2)
    res['pp_stages'] = out

    mesh_dp = make_mesh((2, 1), ('data', 'stage'), device_type='cpu')
    res['dp'] = {'out': pipeline_apply(block_fn, inp['blocks'], inp['x'],
                                       mesh_dp, n_micro=N_MICRO,
                                       batch_axes=('data',))}
    whole = [lambda state, x: torch.func.functional_call(model, state, (x,))]
    res['dp']['stages'] = pipeline_apply_stages(
        whole, [model.state_dict()], inp['clips'], mesh_dp, n_micro=2,
        batch_axes=('data',))
    for name, run in (
            ('guard', lambda: pipeline_apply(
                block_fn, inp['blocks'], inp['x'][:12], mesh_dp,
                n_micro=N_MICRO, batch_axes=('data',))),
            ('stages_guard', lambda: pipeline_apply_stages(
                whole, [model.state_dict()], inp['clips'][:12], mesh_dp,
                n_micro=4, batch_axes=('data',)))):
        try:
            run()
            res['dp'][name] = None
        except AssertionError as e:
            res['dp'][name] = str(e)

    mesh_ep = make_mesh((1, 2), ('data', 'expert'), device_type='cpu')
    experts = moe.expert_sharding(mesh_ep, leaves(inp['experts']))
    router = inp['router'].clone().requires_grad_()
    y, aux, _ = moe.moe_apply(expert_fn, experts, inp['tokens'], router,
                              mesh_ep, capacity_factor=4.0)
    (y.pow(2).mean() + 0.01 * aux).backward()
    res['moe'] = {'experts': experts['w1'].shape[0], 'y': y.detach(),
                  'router_grad': router.grad, 'expert_grads': grads(experts)}

    msr = MultiScaleRelation(**MSTRN)
    msr.load_state_dict(inp['mstrn_state'])
    spec = moe.mstrn_expert_spec(MSTRN['num_inputs'], pad_experts_to=8)
    stacked = moe.mstrn_expert_params(msr, spec)
    with torch.no_grad():
        res['mstrn'] = {
            'experts': moe.expert_sharding(mesh_ep, stacked)['w1'].shape[0],
            'y': moe.mstrn_expert_apply(stacked, spec, inp['frames'],
                                        mesh_ep)}

    weight = inp['serve_w']
    with torch.inference_mode():
        res['serve'] = sharded_apply(lambda w, b: b @ w, mesh_dp)(
            weight, inp['serve_x'])

    torch.save(res, os.path.join(WORK, f'result_{RANK}.pt'))
    torch.distributed.destroy_process_group()
    print(f'TORCH-DIST-PIPELINE-OK rank={RANK}', flush=True)


if __name__ == '__main__':
    RANK, PORT = int(sys.argv[1]), sys.argv[2]
    WORK = os.path.abspath(sys.argv[3])
    main()
