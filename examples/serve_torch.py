#!/usr/bin/env python
"""Online-serving load test on the PyTorch port.

The twin of ``examples/serve.py``: it drives
``pretorched_tpu_torch.serving.serve_model`` as a model server would. N
client threads submit single examples at once; the batcher coalesces them
onto power-of-two buckets. The tool warms every bucket, then reports
requests/s, latency percentiles and the buckets dispatched, and on a CUDA
card the median device time of one bare model forward per bucket (CUDA
events), so the server's overhead over the forward shows.

Payloads: ``tensor`` (preprocessed float examples, channels-first),
``uint8`` (decoded frames, preprocessed on the device) and ``jpeg``
(seeded synthetic 375 x 500 JPEGs, decoded on the client threads). The
served signature is pinned from the arguments, never taken from a
first request.

Usage:
    python examples/serve_torch.py -a resnet50 --bf16 --requests 512 --clients 8
    python examples/serve_torch.py -a resnet50 --payload jpeg --bf16
    python examples/serve_torch.py -a nonlocalresnet3d50 --payload uint8 \
        --bf16 --frames 32 --decode-shape 32,240,320,3 --max-batch 8
    python examples/serve_torch.py -a resnet18 --size 64 --device cpu \
        --requests 16 --max-batch 4
"""

import argparse
import io
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='serving load test (PyTorch)')
    p.add_argument('--arch', '-a', default='resnet50')
    p.add_argument('--pretrained', default='none')
    p.add_argument('--payload', default='tensor',
                   choices=('tensor', 'uint8', 'jpeg'))
    p.add_argument('--requests', type=int, default=128)
    p.add_argument('--clients', type=int, default=8)
    p.add_argument('--size', type=int, default=224,
                   help='crop size of the tensor payload (and of the '
                        "model's settings when they are not 224)")
    p.add_argument('--frames', type=int, default=16,
                   help='clip length for video archs')
    p.add_argument('--decode-shape', default=None,
                   help='uint8/jpeg request geometry, e.g. 256,256,3 or '
                        '32,240,320,3 (default: the model settings\' '
                        'pre-crop size)')
    p.add_argument('--max-batch', type=int, default=64)
    p.add_argument('--max-wait-ms', type=float, default=2.0)
    p.add_argument('--resolver-threads', type=int, default=1)
    p.add_argument('--max-queue', type=int, default=None)
    p.add_argument('--bf16', action='store_true',
                   help='bf16 compute (f32 params) and bf16 preprocess')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default), 'cuda:N' or 'cpu'")
    return p.parse_args(argv)


def synthetic_jpegs(n, height=375, width=500, seed=0):
    """``n`` seeded smooth images encoded as JPEG bytes (quality 90)."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    out = []
    for _ in range(n):
        a, b, c = rng.uniform(0.2, 1.0, 3)
        img = np.stack([(yy * a) % 256, (xx * b) % 256,
                        ((yy + xx) * c) % 256], -1).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format='JPEG', quality=90)
        out.append(buf.getvalue())
    return out


def load_test(srv, requests, clients, make_request):
    """``requests`` single requests from ``clients`` threads, each waiting
    for its result before the next. Returns (sorted latencies in ms, wall
    seconds)."""
    per_client = [requests // clients + (1 if i < requests % clients else 0)
                  for i in range(clients)]
    lat, lock, errors = [], threading.Lock(), []

    def client(i, n_req):
        try:
            for j in range(n_req):
                x = make_request(i, j)
                t0 = time.perf_counter()
                srv.submit(x).result()
                dt = time.perf_counter() - t0
                with lock:
                    lat.append(dt)
        except Exception as e:     # re-raised on the main thread below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i, n))
               for i, n in enumerate(per_client)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return np.sort(np.asarray(lat)) * 1e3, wall


def percentiles(lat_ms):
    n = len(lat_ms)
    return {'p50': float(lat_ms[n // 2]), 'p90': float(lat_ms[int(n * 0.9)]),
            'p99': float(lat_ms[int(n * 0.99)])}


def bucket_forward_ms(model, example_shape, max_batch, device, reps=10):
    """{bucket: median ms of one bare ``model(x)`` on a float batch of that
    many examples}, by CUDA events."""
    out = {}
    b = 1
    g = torch.Generator(device=device).manual_seed(0)
    with torch.inference_mode():
        while b <= max_batch:
            x = torch.randn((b,) + tuple(example_shape), device=device,
                            generator=g)
            model(x)
            torch.cuda.synchronize(device)
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(reps)]
            for e0, e1 in events:
                e0.record()
                model(x)
                e1.record()
            torch.cuda.synchronize(device)
            times = sorted(e0.elapsed_time(e1) for e0, e1 in events)
            out[b] = times[reps // 2]
            b *= 2
    return out


def main(argv=None):
    """Runs the load test; returns a summary dict."""
    args = parse_args(argv)
    import pretorched_tpu_torch as pretorched
    from pretorched_tpu_torch.datasets.native import decoder_name
    from pretorched_tpu_torch.serving import serve_model

    pretrained = None if args.pretrained in ('none', '') else args.pretrained
    model = pretorched.__dict__[args.arch](pretrained=pretrained)
    if args.bf16:
        model.bfloat16()
    video = model.input_ndim == 5
    if args.size != 224 and model.settings is None:
        model.input_size = [3, args.size, args.size]
    crop = max(model.input_size)
    example = (3, args.frames, crop, crop) if video else (3, crop, crop)
    decode = (tuple(int(v) for v in args.decode_shape.split(','))
              if args.decode_shape else None)
    if decode is None and args.payload != 'tensor' and video:
        side = int(crop / 0.875)
        decode = (args.frames, side, side, 3)
    srv = serve_model(
        model, device=args.device, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
        resolver_threads=args.resolver_threads, payload=args.payload,
        decode_shape=decode,
        example_shape=example if args.payload == 'tensor' else None,
        example_dtype=np.float32 if args.payload == 'tensor' else None,
        preprocess_dtype='bfloat16' if args.bf16 else 'float32')
    shape = srv._example_shape
    rng = np.random.RandomState(0)
    if args.payload == 'tensor':
        pool = [rng.rand(*shape).astype(np.float32) for _ in range(8)]
    elif args.payload == 'uint8':
        pool = [rng.randint(0, 256, shape).astype(np.uint8) for _ in range(8)]
    else:
        pool = synthetic_jpegs(8)

    def make_request(i, j):
        return pool[(i + j) % len(pool)]

    with srv:
        b = 1                       # warm every bucket outside the clock
        while b <= args.max_batch:
            srv(list(pool[:1]) * b if args.payload == 'jpeg'
                else np.stack([pool[0]] * b))
            b *= 2
        warm = set(srv.bucket_compiles)
        srv.bucket_compiles.clear()
        lat_ms, wall = load_test(srv, args.requests, args.clients,
                                 make_request)
    n = len(lat_ms)
    summary = {'requests': n, 'clients': args.clients, 'wall_s': wall,
               'req_per_s': n / wall if wall else None,
               'buckets': sorted(srv.bucket_compiles),
               'warmed': sorted(warm), 'payload': args.payload,
               'decoder': decoder_name() if args.payload == 'jpeg' else None,
               'device': str(srv.device)}
    if n == 0:
        print('no requests issued (--requests 0)')
        return summary
    summary.update(percentiles(lat_ms))
    print(f"{args.arch} {args.payload} payload{' bf16' if args.bf16 else ''} "
          f'on {srv.device}: {n} requests, {args.clients} clients, wall '
          f"{wall:.3f} s -> {summary['req_per_s']:.2f} req/s")
    print(f"latency ms: p50 {summary['p50']:.2f}  p90 {summary['p90']:.2f}  "
          f"p99 {summary['p99']:.2f}")
    print(f"buckets dispatched: {summary['buckets']} (warmed "
          f'{summary["warmed"]})')
    if summary['decoder']:
        print(f"JPEG decoder: {summary['decoder']}")
    if srv.device.type == 'cuda':
        fwd = bucket_forward_ms(model, example, args.max_batch, srv.device)
        summary['bucket_forward_ms'] = fwd
        print('bare forward per bucket (CUDA events, median of 10): ' +
              ', '.join(f'{b}: {ms:.3f} ms' for b, ms in fwd.items()))
    else:
        print('bare forward per bucket: not measured (no CUDA device)')
    return summary


if __name__ == '__main__':
    main()
