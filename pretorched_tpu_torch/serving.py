"""Online inference serving: a dynamic-batching executor for the zoo.

Counterpart of ``pretorched_tpu/serving.py:72-572``, with the same public
arguments and failure semantics, on PyTorch and one CUDA card:

* Requests (single examples or small batches) enter a queue and return a
  ``Future`` at once.
* A batcher thread coalesces what is queued, up to ``max_batch``, waiting at
  most ``max_wait_ms`` for stragglers, and pads the batch with its last row
  up to a power-of-two bucket. Padding rows are sliced off before the
  futures resolve, so each result is its request's own rows.
* The batcher stages each bucket in pinned host memory, copies it to the
  card with ``non_blocking=True``, runs ``apply_fn`` eagerly under
  ``torch.inference_mode()``, queues the copy of the ``n`` real output rows
  into pinned host memory and records a ``torch.cuda.Event``. It hands
  ``(items, n, out, event)`` to a resolver thread and goes back to the
  queue: it never waits for the card. A resolver waits on the event and
  fans the rows out to the futures (``resolver_threads`` of them, default
  1). Each bucket stages into buffers of its own, so no copy in flight is
  overwritten.
* Nothing is compiled: ``bucket_compiles`` keeps the JAX package's name and
  holds the set of bucket sizes dispatched.
* Admission is bounded by ``max_queue`` examples (``ServerOverloaded``);
  a request queued longer than ``request_timeout_ms`` fails with
  ``TimeoutError`` when the batcher reaches it; a malformed or zero-row
  request fails only its caller; a client's ``Future.cancel()`` harms no
  one else; an error in ``apply_fn`` or on the card (a kernel that does
  not build or launch included) fails every queued and in-flight future
  and makes ``close()`` raise. Nothing falls back to another device.

``serve_model`` serves a zoo model with three payloads: ``'tensor'``
(preprocessed float examples in the model's own channels-first layout:
(3, H, W) for an image, (3, T, H, W) for a clip), ``'uint8'`` (decoded
channels-last frames, (H, W, 3) or (T, H, W, 3), preprocessed on the card
by ``transforms.fused``) and ``'jpeg'`` (encoded bytes, decoded in the
submitting thread, then the uint8 path).

Inference mode, autocast, the current device and the current stream are
per thread; the batcher enters them itself.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np
import torch


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class ServerOverloaded(RuntimeError):
    """Raised by ``submit`` when admitting a request would put more than
    ``max_queue`` examples in the queue: load shedding at admission instead
    of unbounded latency."""


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(f'device {device!r}: CUDA is not available; '
                               "pass device='cpu' to serve on the CPU")
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError(f'device must be cuda or cpu, got {device!r}')
    return dev


class InferenceServer:
    """Dynamic-batching executor over one eager forward.

    Args:
      apply_fn: ``(model, batch) -> outputs``, a tensor whose leading axis
        matches the batch's. Called on the batcher thread, under
        ``torch.inference_mode()``, on a batch on ``device``.
      model: passed to ``apply_fn`` as is (the module, or anything it needs).
      device: where batches run, ``'cuda'`` (the default; raises when CUDA
        is missing), ``'cuda:N'`` or ``'cpu'``.
      max_batch: upper bucket bound (also the largest coalesced batch).
      max_wait_ms: how long the batcher waits for more requests once it has
        one (0 = take what is queued).
      example_ndim: rank of ONE example; ``submit`` takes one example or a
        batch (rank + 1) of them.
      example_shape / example_dtype: pin the served signature up front.
        When omitted, the FIRST request defines it for the server's
        lifetime, as in the JAX package, so production callers pin it.
      max_queue: admission bound in examples (None = unbounded).
      request_timeout_ms: a request still queued after this long fails with
        ``TimeoutError`` (None = never). Dispatched buckets run to the end.
      resolver_threads: how many dispatched buckets can be read back and
        fanned out at once.
      request_transform: callable applied to each raw request in the
        SUBMITTING thread before validation (how the JPEG payload decodes
        on the clients' threads).
    """

    def __init__(self, apply_fn: Callable, model, *, device='cuda',
                 max_batch: int = 64, max_wait_ms: float = 2.0,
                 example_ndim: Optional[int] = None,
                 example_shape: Optional[tuple] = None, example_dtype=None,
                 max_queue: Optional[int] = None,
                 request_timeout_ms: Optional[float] = None,
                 resolver_threads: int = 1,
                 request_transform: Optional[Callable] = None):
        self.device = _device(device)
        self._fn = apply_fn
        self._model = model
        self._transform = request_transform
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1000.0
        self.example_ndim = example_ndim
        self.max_queue = max_queue
        self._timeout = (None if request_timeout_ms is None
                         else request_timeout_ms / 1000.0)
        self._pending = 0          # queued examples (admission accounting)
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._exc: Optional[BaseException] = None
        # guards submit's check-then-put against close() and _die: once
        # _closed or _exc is seen under the lock, no request can enter the
        # queue after the final drain and hang forever
        self._lock = threading.Lock()
        self._example_shape = (None if example_shape is None
                               else tuple(example_shape))
        self._example_dtype = (None if example_dtype is None
                               else np.dtype(example_dtype))
        self.bucket_compiles: set = set()      # bucket sizes dispatched
        self._resolve_q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='pretorched-serving-batcher')
        self._resolvers = [
            threading.Thread(target=self._resolve_loop, daemon=True,
                             name=f'pretorched-serving-resolver-{i}')
            for i in range(max(int(resolver_threads), 1))]
        self._thread.start()
        for r in self._resolvers:
            r.start()

    # ------------------------------------------------------------- client
    def submit(self, x) -> Future:
        """Enqueue one example (``example_ndim``) or a batch of them (numpy
        or a CPU tensor); returns a Future of the output rows as a CPU
        tensor (the leading axis dropped for a single example)."""
        if self._transform is not None:
            x = self._transform(x)
        x = np.asarray(x)
        single = self.example_ndim is not None and x.ndim == self.example_ndim
        if single:
            x = x[None]
        if x.shape[0] > self.max_batch:
            raise ValueError(f'batch {x.shape[0]} > max_batch '
                             f'{self.max_batch}; split the request')
        if x.shape[0] == 0:
            # a zero-row batch would break the batcher's pad-to-bucket and
            # kill the server for everyone: fail its caller
            raise ValueError('empty batch (0 examples)')
        with self._lock:
            if self._closed:
                raise RuntimeError('server is closed')
            if self._exc is not None:
                raise RuntimeError('server batcher died') from self._exc
            # one malformed request fails here, at its caller, not in the
            # batcher's concatenate, which would kill the server
            if self._example_shape is None:
                self._example_shape = x.shape[1:]
            if self._example_dtype is None:
                self._example_dtype = x.dtype
            if x.shape[1:] != self._example_shape or \
                    x.dtype != self._example_dtype:
                raise ValueError(
                    f'request shape/dtype {x.shape[1:]}/{x.dtype} does not '
                    f'match the served signature '
                    f'{self._example_shape}/{self._example_dtype}')
            if (self.max_queue is not None
                    and self._pending + x.shape[0] > self.max_queue):
                raise ServerOverloaded(
                    f'{self._pending} examples queued; admitting '
                    f'{x.shape[0]} more would exceed max_queue '
                    f'{self.max_queue}')
            self._pending += x.shape[0]
            fut: Future = Future()
            # the trailing cell marks the request finished (future set,
            # _pending decremented); _finish flips it exactly once
            self._q.put((x, single, fut, time.monotonic(), [False]))
        return fut

    def _dec_pending(self, k: int):
        with self._lock:
            self._pending -= k

    def _finish(self, item, *, result=None, exc=None):
        """Resolve one request exactly once: decrement the admission count
        and set the future, tolerating a client's ``Future.cancel()`` (its
        ``set_result`` raises ``InvalidStateError``, which must not kill a
        resolver). The cell keeps a request that a dying bucket already
        resolved from being counted again by ``_die``."""
        x, _, fut, _, fin = item
        if fin[0]:
            return
        fin[0] = True
        self._dec_pending(x.shape[0])
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except Exception:   # InvalidStateError: the client cancelled a
            pass            # queued request; nothing is owed to it

    def __call__(self, x):
        """Synchronous convenience: submit and wait."""
        return self.submit(x).result()

    def close(self, timeout: float = 30.0):
        """Drain outstanding requests and stop the threads. Raises when the
        batcher or a resolver died, or when they did not drain in
        ``timeout`` seconds (call again with a larger one)."""
        with self._lock:
            first = not self._closed
            self._closed = True
        if first:
            self._q.put(None)                  # wake the batcher
        deadline = time.monotonic() + timeout
        for t in (self._thread, *self._resolvers):
            if t.is_alive():
                # join on every call: a retry after a drain timeout must
                # wait again
                t.join(max(deadline - time.monotonic(), 0.001))
        if self._exc is not None:
            raise RuntimeError('server batcher died') from self._exc
        if self._thread.is_alive() or any(r.is_alive()
                                          for r in self._resolvers):
            raise RuntimeError(
                f'batcher did not drain within {timeout}s (a first launch '
                f'that builds the CUDA kernels can take that long); call '
                f'close(timeout=...) again with a larger timeout')

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ batcher
    def _expired(self, item) -> bool:
        """Fail a request that sat queued past ``request_timeout_ms``."""
        if self._timeout is None:
            return False
        if time.monotonic() - item[3] <= self._timeout:
            return False
        self._finish(item, exc=TimeoutError(
            f'request expired after {self._timeout * 1000:.0f} ms in queue '
            f'(request_timeout_ms; the server is overloaded)'))
        return True

    def _take_batch(self):
        """Collect queued requests up to max_batch. Returns None on
        shutdown, or [] when it only expired stale requests and the queue
        drained."""
        while True:
            item = self._q.get()
            if item is None:
                return None
            if not self._expired(item):
                break
            if self._q.empty():
                return []
        items = [item]
        n = item[0].shape[0]
        t_end = time.monotonic() + self.max_wait
        while n < self.max_batch:
            try:
                timeout = t_end - time.monotonic()
                nxt = self._q.get(timeout=max(timeout, 0)) \
                    if timeout > 0 else self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)              # re-signal shutdown
                break
            if self._expired(nxt):
                continue
            if n + nxt[0].shape[0] > self.max_batch:
                self._q.put(nxt)               # runs in the next bucket
                break
            items.append(nxt)
            n += nxt[0].shape[0]
        return items

    def _stage(self, items):
        """(batch on the device, n real rows): the requests' rows and
        copies of the last one up to the bucket size, written once into a
        fresh (pinned, for CUDA) host buffer."""
        n = sum(it[0].shape[0] for it in items)
        bucket = min(_next_pow2(n), self.max_batch)
        self.bucket_compiles.add(bucket)
        first = items[0][0]
        dtype = torch.from_numpy(first[:0]).dtype
        host = torch.empty((bucket,) + first.shape[1:], dtype=dtype,
                           pin_memory=self.device.type == 'cuda')
        buf = host.numpy()
        np.concatenate([it[0] for it in items], axis=0, out=buf[:n])
        buf[n:] = buf[n - 1]
        return host.to(self.device, non_blocking=True), n

    def _loop(self):
        """Batcher: coalesce -> stage -> launch -> hand to a resolver. It
        never waits for the card."""
        items = None
        try:
            if self.device.type == 'cuda':
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                while True:
                    items = self._take_batch()
                    if items is None:
                        break
                    if not items:               # only expired requests
                        continue
                    if self._exc is not None:   # a resolver died
                        raise self._exc
                    x, n = self._stage(items)
                    out = self._fn(self._model, x)
                    event = None
                    if self.device.type == 'cuda':
                        rows = out[:n]
                        host = torch.empty(rows.shape, dtype=rows.dtype,
                                           pin_memory=True)
                        host.copy_(rows, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record()
                        # the device output stays referenced until the
                        # resolver is done with the bucket
                        out = (host, out)
                    self._resolve_q.put((items, n, out, event))
                    items = None
        except BaseException as e:              # propagate to the clients
            self._die(e, list(items or []))
        finally:
            for _ in self._resolvers:           # each resolver drains what
                self._resolve_q.put(None)       # it holds, then stops

    def _resolve_loop(self):
        """Resolver: wait for a dispatched bucket and fan its rows out to
        the requests' futures. Buckets resolve independently."""
        entry = None
        try:
            while True:
                entry = self._resolve_q.get()
                if entry is None:
                    return
                self._resolve(*entry)
                entry = None
        except BaseException as e:              # device errors land here
            self._die(e, list(entry[0]) if entry is not None else [])

    def _die(self, e: BaseException, in_flight: list):
        """Record the fatal error (new submits are refused from here on)
        and fail every queued or dispatched request's future."""
        with self._lock:
            if self._exc is None:
                self._exc = e
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                in_flight.append(item)
        while True:
            try:
                entry = self._resolve_q.get_nowait()
            except queue.Empty:
                break
            if entry is not None:
                in_flight.extend(entry[0])
        for item in in_flight:
            self._finish(item, exc=self._exc)

    @staticmethod
    def _split_outputs(out, start, stop):
        # a copy: the future owns its rows, not a view of the bucket's
        # (pinned, inference-mode) buffer
        return out[start:stop].clone()

    def _resolve(self, items, n, out, event):
        if event is not None:
            event.synchronize()
            out = out[0]                        # the pinned host rows
        off = 0
        for item in items:
            x, single = item[0], item[1]
            k = x.shape[0]
            piece = self._split_outputs(out, off, off + k)
            self._finish(item, result=piece[0] if single else piece)
            off += k


def _fit_uint8(img: np.ndarray, shape) -> np.ndarray:
    """Host-side fit of a decoded image onto the served uint8 signature:
    short-side resize and center crop (PIL bilinear). A no-op when the
    decode already matches; the antialiased resize of the model's settings
    runs on the device in ``transforms.fused``."""
    if img.shape == tuple(shape):
        return img
    from PIL import Image
    th, tw = shape[:2]
    h, w = img.shape[:2]
    s = max(th / h, tw / w)
    nh, nw = max(int(round(h * s)), th), max(int(round(w * s)), tw)
    arr = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
    top, left = (nh - th) // 2, (nw - tw) // 2
    return arr[top:top + th, left:left + tw]


def _jpeg_transform(decode_shape, threads: int):
    """request_transform that decodes JPEG bytes (or a list of them) to
    uint8 arrays on the served decode geometry, in the submitting thread,
    with a batch-wide DCT ``scale_denom``: the largest power-of-two
    downscale that keeps every image's short side at or above the served
    one."""
    from .datasets.native import decode_jpeg_batch, jpeg_short_side
    target_short = min(decode_shape[:2])

    def transform(req):
        if isinstance(req, (bytes, bytearray, memoryview)):
            bufs, single = [bytes(req)], True
        elif (isinstance(req, (list, tuple)) and req
              and isinstance(req[0], (bytes, bytearray, memoryview))):
            bufs, single = [bytes(b) for b in req], False
        else:
            return req          # already decoded: the uint8 path
        denom = 8
        for b in bufs:
            s = jpeg_short_side(b)
            if s is None:
                denom = 1
                break
            while denom > 1 and s // denom < target_short:
                denom //= 2
        imgs = decode_jpeg_batch(bufs, threads=threads, scale_denom=denom)
        arr = np.stack([_fit_uint8(im, decode_shape) for im in imgs])
        return arr[0] if single else arr

    return transform


_MODES = ('forward', 'features', 'logits')


def serve_model(model, *, mode: str = 'forward', device='cuda',
                max_batch: int = 64, max_wait_ms: float = 2.0,
                example_shape: Optional[tuple] = None, example_dtype=None,
                max_queue: Optional[int] = None,
                request_timeout_ms: Optional[float] = None,
                resolver_threads: int = 1, payload: str = 'tensor',
                decode_shape: Optional[tuple] = None,
                preprocess_dtype='float32',
                jpeg_threads: int = 4) -> InferenceServer:
    """InferenceServer over a zoo ``PretrainedModel``, which it moves to
    ``device`` and puts in eval mode.

    ``mode`` is 'forward' | 'features' | 'logits'. Pass ``example_shape``
    in production (the model's channels-first ``input_size``, e.g.
    ``(3, 224, 224)``) so a malformed first request cannot define the
    served signature.

    ``payload`` picks the request format:

    * ``'tensor'``: preprocessed float examples, channels-first;
    * ``'uint8'``: decoded uint8 frames, channels-last, at ``decode_shape``
      (default for an image model: the pre-crop resize size, e.g.
      (256, 256, 3) for 224 px at scale 0.875; a video model must pass
      one, e.g. (32, 240, 320, 3)). The served program runs
      ``fused_preprocess`` on the device, per frame, in
      ``preprocess_dtype`` ('float32' or 'bfloat16'), and permutes clips
      to (B, 3, T, S, S);
    * ``'jpeg'``: encoded JPEG bytes (one ``bytes`` or a list), decoded in
      the submitting thread on ``jpeg_threads`` threads and fitted to
      ``decode_shape``, then the uint8 path (images only).

    uint8 and jpeg payloads pin the served signature to ``decode_shape``
    and uint8."""
    if mode not in _MODES:
        raise ValueError(f'mode must be one of {_MODES}, got {mode!r}')
    dev = _device(device)
    model.to(dev).eval()
    forward = model if mode == 'forward' else getattr(model, mode)
    # one example = the model's batched input rank minus the batch axis
    example_ndim = (getattr(model, 'input_ndim', None) or 4) - 1
    request_transform = None

    if payload == 'tensor':
        def apply_fn(_, x):
            return forward(x)
    elif payload in ('uint8', 'jpeg'):
        from .transforms.fused import _settings_tuple, fused_preprocess
        src = model.settings if model.settings is not None else model
        if not (isinstance(src, dict) or hasattr(src, 'mean')):
            raise ValueError(
                'uint8/jpeg payloads need preprocessing settings; this '
                'model carries no mean/std metadata')
        spec = _settings_tuple(src)
        dtype = (getattr(torch, preprocess_dtype)
                 if isinstance(preprocess_dtype, str) else preprocess_dtype)
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f'preprocess_dtype must be float32 or '
                             f'bfloat16, got {preprocess_dtype!r}')
        if decode_shape is None:
            if example_ndim != 3:
                raise ValueError(
                    'video models need an explicit decode_shape, e.g. '
                    '(frames, 256, 256, 3)')
            short = int(np.floor(max(spec[0]) / spec[5]))  # crop / scale
            decode_shape = (short, short, 3)
        # these payloads pin the signature to decode_shape and uint8; a
        # conflicting explicit one must fail here, not be overwritten
        if example_shape is not None \
                and tuple(example_shape) != tuple(decode_shape):
            raise ValueError(
                f'payload={payload!r} pins the served signature to '
                f'decode_shape {tuple(decode_shape)}; got conflicting '
                f'example_shape {tuple(example_shape)}; pass decode_shape= '
                f'instead')
        if example_dtype is not None and np.dtype(example_dtype) != np.uint8:
            raise ValueError(
                f'payload={payload!r} serves uint8 requests; got '
                f'example_dtype {np.dtype(example_dtype)}')
        example_shape = tuple(decode_shape)
        example_dtype = np.uint8

        def apply_fn(_, x_u8):
            if x_u8.dim() == 5:     # clips: preprocess per frame
                b, t = x_u8.shape[:2]
                x = fused_preprocess(x_u8.flatten(0, 1), src, dtype=dtype)
                x = x.reshape((b, t) + x.shape[1:])
                x = x.permute(0, 4, 1, 2, 3).contiguous()
            else:
                x = fused_preprocess(x_u8, src, channels_last=False,
                                     dtype=dtype)
            return forward(x)

        if payload == 'jpeg':
            if example_ndim != 3:
                raise ValueError('jpeg payload serves single images only')
            request_transform = _jpeg_transform(decode_shape, jpeg_threads)
    else:
        raise ValueError(f"payload must be 'tensor'|'uint8'|'jpeg', "
                         f'got {payload!r}')

    return InferenceServer(apply_fn, model, device=dev, max_batch=max_batch,
                           max_wait_ms=max_wait_ms,
                           example_ndim=example_ndim,
                           example_shape=example_shape,
                           example_dtype=example_dtype,
                           max_queue=max_queue,
                           request_timeout_ms=request_timeout_ms,
                           resolver_threads=resolver_threads,
                           request_transform=request_transform)
