"""Streaming inference serving (counterpart of unet_convlstm_tpu/serve.py).

* ``StreamingPredictor`` — restores a ``.pt`` checkpoint (weights, BatchNorm
  statistics and the normalization manifest, so raw sensor frames go in and
  physical m/s come out), keeps named sessions each carrying the (h, c)
  recurrence on the device, and runs one forward step per request. A
  frame costs the same however long its session has run. The sessions of
  one (B, H, W) hold slots (row ranges) of one batched state, so that
  ``predict_many`` over all of them in the order of their slots hands the
  step that batch as it lies, and a call over all of them in another order
  leaves their slots in its order; frames and outputs go through host
  buffers reused from request to request, page-locked on a card.
* ``serve_http`` / CLI ``serve`` — a stdlib HTTP front end: JSON for
  control, raw little-endian float32 tensors for data.

Endpoints (the JAX package's wire format):
    GET  /healthz                     → {"status": "ok", "model": ...}
    POST /v1/session                  {"batch": B, "height": H, "width": W}
                                      → {"session_id": ...}
    GET  /v1/session/<sid>            → session info
    POST /v1/predict/<sid>            body raw f32 [B,T,H,W,Cin], header
                                      X-Shape "B,T,H,W,C" → raw f32
                                      [B,T,H,W,out], X-Shape set
    POST /v1/predict-batch            X-Sessions "sid,sid,...", X-Shape
                                      "N,B,T,H,W,C" → raw f32 [N,B,T,H,W,out]
    DELETE /v1/session/<sid>          → {"closed": true}

The step runs the model with both hand-written kernel flags on (the ConvLSTM
gate update and the fused 3x3 conv; the ResNet18 family's decoder does not
fuse, as in the JAX package), under ``torch.inference_mode()``.
Device work is serialized with a lock (one card, many HTTP threads).
A request's spans (``core/trace.py``): ``serve.stage_in`` (the frame
blocks written into the host buffer and copied on to the card, the
sessions' rows of the state gathered where they are not the whole group),
``serve.forward`` (the step's dispatch) and ``serve.stage_out`` (the
card→host copy, the new state written back, one array a session).
``state_counts()`` counts the requests of each state path.

``int8=True`` serves the post-training int8 model (``ops/quant.py``): every
conv int8 on the card's int8 kernel (K8) with dynamic activation scales, or
static ones calibrated on ``int8_calib_frames`` (raw [B, T, H, W, C] frame
blocks, normalized with the checkpoint's manifest before calibrating). A
checkpoint written by ``convert-checkpoint --quantize`` serves int8 with no
flag.
"""

from __future__ import annotations

import json
import math
import threading
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .core import trace
from .core.dtypes import DEFAULT_POLICY, resolve_device
from .models.registry import build_model, model_from_checkpoint
from .ops.normalize import NormStats, denormalize_y, normalize_x
from .ops.quant import calibrate_tree, quantize_model
from .train.checkpoint import restore_checkpoint


class _Group:
    """The ConvLSTM states of one (B, H, W) geometry's sessions as one
    batch: slot i owns rows [i·B, (i + 1)·B) of every tensor of ``state``
    (the model's state tree: h in the compute dtype, c in f32). An open
    takes a freed slot, and grows the group only when none is free; a
    request over all of its live sessions leaves it holding just their
    rows, in the request's order; the last close releases it. Read and
    written under the predictor's device lock."""

    def __init__(self, batch: int):
        self.batch = batch
        self.state = None
        self.slots = 0
        self.free: List[int] = []

    def rows(self, slot: int) -> slice:
        return slice(slot * self.batch, (slot + 1) * self.batch)

    def live(self) -> int:
        return self.slots - len(self.free)


class _Session:
    """A stream: its geometry, its slot in that geometry's group, the
    frames it has seen, and the lock that orders its requests."""

    def __init__(self, group: _Group, slot: int, height: int, width: int):
        self.group, self.slot = group, slot
        self.batch, self.height, self.width = group.batch, height, width
        self.frames_seen = 0
        self.lock = threading.Lock()

    @property
    def state(self):
        """The session's (h, c) tree: views of its slot's rows."""
        rows = self.group.rows(self.slot)
        return _map_state(lambda a: a[rows], self.group.state)


def _map_state(fn: Callable, *states):
    """Apply ``fn`` leaf-wise over states {name: [(h, c), ...]}."""
    return {k: [tuple(fn(*leaves) for leaves in zip(*carries))
                for carries in zip(*(s[k] for s in states))]
            for k in states[0]}


# requests whose sessions' states went to the step as their group holds
# them ("resident"), and those that read and wrote back their rows of it
# ("gathered"); over the process, as ops.kernels counts its launches
_STATE_PATHS = {"resident": 0, "gathered": 0}


def state_counts() -> Dict[str, int]:
    """How many requests the resident and the gathered path have served."""
    return dict(_STATE_PATHS)


class StreamingPredictor:
    """Checkpoint-backed stateful streaming inference engine."""

    def __init__(self, checkpoint_path: str, int8: bool = False,
                 device=None, int8_calib_frames=None):
        self.device = resolve_device(device)
        self.policy = DEFAULT_POLICY
        model_state, meta = restore_checkpoint(checkpoint_path)
        model_cfg = meta["config"].get("model", meta["config"])
        self.model_cfg = dict(model_cfg)
        self.cfg, init, self._apply_fn, self._init_state = build_model(
            model_cfg)
        self.model = model_from_checkpoint(init, model_state, meta,
                                           self.device)
        if "norm_stats" not in meta:
            raise ValueError(
                "checkpoint has no normalization manifest (norm_stats): it "
                "cannot map raw frames to model inputs; re-save it with one")
        self.norm_stats = NormStats.from_dict(meta["norm_stats"])
        # an int8 checkpoint (convert-checkpoint --quantize) serves int8
        # with no flag
        self.int8 = int8 or bool(meta.get("int8"))
        self.int8_calib_blocks = 0     # calibrated static scales when > 0
        if self.int8:
            if not meta.get("int8"):
                self.model = quantize_model(self.model)
            if int8_calib_frames is not None:
                # materialized before anything takes its length: a
                # generator is consumed once
                frames = list(int8_calib_frames)
                batches = [normalize_x(torch.tensor(
                    np.asarray(b, np.float32), device=self.device),
                    self.norm_stats) for b in frames]
                self.model = calibrate_tree(
                    self._apply_fn, self.model, batches, policy=self.policy,
                    use_pallas=True, use_fused_doubleconv=True)
                self.int8_calib_blocks = len(frames)
        self._sessions: Dict[str, _Session] = {}
        self._groups: Dict[Tuple[int, int, int], _Group] = {}
        self._sessions_lock = threading.Lock()
        self._device_lock = threading.Lock()
        # the staging buffers ("frames" and "outputs" on the host, "frames"
        # on the device), reused from request to request and touched only
        # under the device lock: the host ones page-locked where the device
        # is a card
        self._pin = self.device.type == "cuda"
        self._buffers: Dict[Tuple[str, bool], torch.Tensor] = {}
        self._out_copied = torch.cuda.Event() if self._pin else None

    @torch.inference_mode()
    def _step(self, x_raw: torch.Tensor, state):
        x = normalize_x(x_raw, self.norm_stats)
        y, new_state, _ = self._apply_fn(
            self.model, x, state=state, train=False, policy=self.policy,
            use_pallas=True, use_fused_doubleconv=True)
        return denormalize_y(y.float(), self.norm_stats), new_state

    # -- staging --------------------------------------------------------------

    def _buffer(self, kind: str, shape: tuple,
                on_device: bool = False) -> torch.Tensor:
        """The reused f32 buffer of a kind, on the host or the device,
        viewed as ``shape``: one a kind and side, replaced only by a larger
        one when a request needs more than it holds."""
        n, key = math.prod(shape), (kind, on_device)
        buf = self._buffers.get(key)
        if buf is None or buf.numel() < n:
            buf = self._buffers[key] = (
                torch.empty(n, dtype=torch.float32, device=self.device)
                if on_device else
                torch.empty(n, dtype=torch.float32, pin_memory=self._pin))
        return buf[:n].view(shape)

    def _stage_in(self, blocks, shape: tuple) -> torch.Tensor:
        """The frame blocks, one after another, into their rows of the
        host buffer, each block's rows copied on to the device buffer as
        soon as they are written; returns the device buffer.

        Under the device lock: a request keeps it until its card→host
        copy, which its stream runs after its host→card copies, has
        finished, so no copy still reads the host buffer when the next
        request writes it. (One that raised in between leaves at most a
        copy that the next request's copy, later on the same stream,
        overwrites.)"""
        host = self._buffer("frames", shape)
        host_np = host.numpy()
        dev = self._buffer("frames", shape, on_device=True)
        b = shape[0] // len(blocks)
        for i, f in enumerate(blocks):
            rows = slice(i * b, (i + 1) * b)
            np.copyto(host_np[rows], f, casting="unsafe")
            dev[rows].copy_(host[rows], non_blocking=True)
        return dev

    def _index(self, slots: List[int], batch: int) -> torch.Tensor:
        """The group rows of ``slots``, in order, on the device."""
        idx = torch.tensor([r for s in slots
                            for r in range(s * batch, (s + 1) * batch)])
        if self._pin:
            idx = idx.pin_memory()
        return idx.to(self.device, non_blocking=True)

    def _serve(self, sess: List[_Session], blocks, shape) -> List[np.ndarray]:
        """One step for sessions of one group (their locks held), their
        frame blocks of one shape; a freshly allocated output array each.

        Where the sessions' slots are all of the group's, in order, the
        group's state goes to the step as it lies (the resident path);
        otherwise one gather a tensor reads their rows (the gathered path).
        Where the sessions are all of the group's live ones, the new state
        becomes the group's, their slots renumbered in the call's order, so
        that the next call in that order is resident; otherwise one
        scatter a tensor writes their rows back."""
        g, n = sess[0].group, len(sess)
        with self._device_lock, torch.inference_mode():
            slots = [s.slot for s in sess]
            with trace.span("serve.stage_in"):
                x = self._stage_in(blocks, (n * g.batch,) + tuple(shape[1:]))
                resident = slots == list(range(g.slots))
                if resident:
                    state = g.state
                else:
                    rows = self._index(slots, g.batch)
                    state = _map_state(lambda a: a.index_select(0, rows),
                                       g.state)
            with trace.span("serve.forward"):
                y, new_state = self._step(x, state)
            with trace.span("serve.stage_out"):
                host = self._buffer("outputs", tuple(y.shape))
                host.copy_(y, non_blocking=True)
                if self._pin:
                    self._out_copied.record(
                        torch.cuda.current_stream(self.device))
                # the state's write-back runs on the card while the host
                # waits for the outputs
                if n == g.live():
                    g.state, g.slots, g.free = new_state, n, []
                    for i, s in enumerate(sess):
                        s.slot = i
                else:
                    _map_state(lambda a, b: a.index_copy_(0, rows, b),
                               g.state, new_state)
                _STATE_PATHS["resident" if resident else "gathered"] += 1
                if self._pin:
                    self._out_copied.synchronize()
                host_np, b = host.numpy(), y.shape[0] // n
                return [host_np[i * b:(i + 1) * b].copy() for i in range(n)]

    # -- session management -------------------------------------------------

    def _input_channels(self) -> int:
        if self.model_cfg.get("type", "custom") == "custom":
            return 2 * self.model_cfg.get("in_channels_per_sat", 1)
        return self.model_cfg.get("in_channels", 2)

    def open_session(self, batch: int, height: int, width: int) -> str:
        sid = uuid.uuid4().hex[:16]
        with self._device_lock, torch.inference_mode():
            g = self._groups.setdefault((batch, height, width), _Group(batch))
            if g.free:
                slot = g.free.pop()
                _map_state(lambda a: a[g.rows(slot)].zero_(), g.state)
            else:
                slot, g.slots = g.slots, g.slots + 1
                # zero carry in the dtypes the step returns: h in the
                # compute dtype, c in f32
                zero = {k: [(h.to(self.policy.compute_dtype),
                             c.to(self.policy.accum_dtype)) for h, c in v]
                        for k, v in self._init_state(
                            batch, height, width, device=self.device).items()}
                g.state = zero if g.state is None else _map_state(
                    lambda a, z: torch.cat([a, z]), g.state, zero)
        with self._sessions_lock:
            self._sessions[sid] = _Session(g, slot, height, width)
        return sid

    def close_session(self, sid: str) -> bool:
        with self._sessions_lock:
            s = self._sessions.pop(sid, None)
        if s is None:
            return False
        # after the session's request in flight, if any, has written its
        # rows: the next open may take the slot
        with s.lock, self._device_lock:
            g = s.group
            g.free.append(s.slot)
            if not g.live():            # the last: its state is released
                g.state, g.slots, g.free = None, 0, []
        return True

    def session_info(self, sid: str) -> Optional[Dict[str, Any]]:
        s = self._sessions.get(sid)
        if s is None:
            return None
        return {"batch": s.batch, "height": s.height, "width": s.width,
                "frames_seen": s.frames_seen}

    # -- inference ----------------------------------------------------------

    def _check_frames(self, shape, batch: int, height: int, width: int):
        if len(shape) != 5:
            raise ValueError(f"frames must be [B,T,H,W,C], got {shape}")
        B, T, H, W, C = shape
        if (B, H, W) != (batch, height, width):
            raise ValueError(f"frame geometry {B}x{H}x{W} does not match "
                             f"session {batch}x{height}x{width}")
        # T and C are client errors (HTTP 400), not faults inside the step
        if T < 1:
            raise ValueError("frames must contain at least one time step "
                             f"(got T={T})")
        if C != self._input_channels():
            raise ValueError(f"frames have {C} channels; the model "
                             f"expects {self._input_channels()}")

    def predict(self, sid: str, frames: np.ndarray) -> np.ndarray:
        """frames: raw [B, T, H, W, Cin] float32 (T >= 1). Advances the
        session state by T frames; returns [B, T, H, W, out] predictions."""
        s = self._sessions.get(sid)
        if s is None:
            raise KeyError(f"unknown session {sid!r}")
        shape = np.shape(frames)
        self._check_frames(shape, s.batch, s.height, s.width)
        with s.lock:                    # per-session state consistency
            # a concurrent DELETE may have closed the session meanwhile
            with self._sessions_lock:
                if self._sessions.get(sid) is not s:
                    raise KeyError(f"unknown session {sid!r}")
            [y] = self._serve([s], [frames], shape)
            s.frames_seen += shape[1]
        return y

    def predict_many(self, sids: List[str], frames_list) -> List[np.ndarray]:
        """One batched step for N same-geometry sessions.

        Each session's recurrent state advances exactly as if its block had
        gone through ``predict``, but the card sees one [N·B] batch. It
        goes to the step as the geometry's group holds it where ``sids``
        are all of the group's sessions in the order of their slots: in the
        order they were opened, or that of the last call over all of
        them."""
        if not sids:
            raise ValueError("predict_many needs at least one session")
        if len(set(sids)) != len(sids):
            raise ValueError("duplicate session ids in predict_many")
        if len(frames_list) != len(sids):
            raise ValueError(f"{len(sids)} sessions but "
                             f"{len(frames_list)} frame blocks")
        if len(sids) == 1:
            return [self.predict(sids[0], frames_list[0])]
        sess = []
        for sid in sids:
            s = self._sessions.get(sid)
            if s is None:
                raise KeyError(f"unknown session {sid!r}")
            sess.append(s)
        shapes = {np.shape(f) for f in frames_list}
        if len(shapes) != 1:
            raise ValueError(f"frame blocks differ in shape: {shapes}")
        geoms = {(s.batch, s.height, s.width) for s in sess}
        if len(geoms) != 1:
            raise ValueError(f"sessions differ in geometry: {geoms}")
        (shape,), (geom,) = shapes, geoms
        self._check_frames(shape, *geom)

        # every session lock in sid-sorted order, so that two overlapping
        # predict_many calls cannot deadlock
        order = sorted(range(len(sess)), key=lambda i: sids[i])
        held = []
        try:
            for i in order:
                sess[i].lock.acquire()
                held.append(sess[i])
                with self._sessions_lock:
                    if self._sessions.get(sids[i]) is not sess[i]:
                        raise KeyError(f"unknown session {sids[i]!r}")
            ys = self._serve(sess, frames_list, shape)
            for s in sess:
                s.frames_seen += shape[1]
            return ys
        finally:
            for s in held:
                s.lock.release()

    def warmup(self, batch: int, height: int, width: int,
               seq_len: int = 1) -> None:
        """Run one step for a geometry: builds the kernels and lets cuDNN
        pick its algorithms before the first live request."""
        sid = self.open_session(batch, height, width)
        try:
            self.predict(sid, np.zeros((batch, seq_len, height, width,
                                        self._input_channels()), np.float32))
        finally:
            self.close_session(sid)


# ---------------------------------------------------------------------------
# HTTP front end (stdlib only)
# ---------------------------------------------------------------------------

def _make_handler(predictor: StreamingPredictor):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet by default
            pass

        def _json(self, code: int, obj: Dict[str, Any]):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _tensor(self, arr: np.ndarray):
            body = np.ascontiguousarray(arr, dtype="<f4").tobytes()
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("X-Shape", ",".join(map(str, arr.shape)))
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _route(self):
            """(path, last segment) with any query string stripped."""
            path = self.path.partition("?")[0]
            return path, path.rsplit("/", 1)[-1]

        def do_GET(self):
            path, sid = self._route()
            if path == "/healthz":
                self._json(200, {"status": "ok",
                                 "model": predictor.model_cfg})
            elif path.startswith("/v1/session/"):
                info = predictor.session_info(sid)
                if info is None:
                    self._json(404, {"error": "unknown session"})
                else:
                    self._json(200, info)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            # drain the body first: a keep-alive connection would otherwise
            # parse an unread payload as the next request line
            body = self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))
            path, sid = self._route()
            try:
                if path == "/v1/session":
                    req = json.loads(body or b"{}")
                    missing = [k for k in ("batch", "height", "width")
                               if k not in req]
                    if missing:
                        self._json(400, {"error": "missing field(s): "
                                         + ", ".join(missing)})
                        return
                    sid = predictor.open_session(
                        int(req["batch"]), int(req["height"]),
                        int(req["width"]))
                    self._json(200, {"session_id": sid})
                elif path.startswith("/v1/predict/"):
                    if self.headers.get("X-Shape") is None:
                        self._json(400, {"error": "missing X-Shape header"})
                        return
                    shape = tuple(int(v) for v in
                                  self.headers["X-Shape"].split(","))
                    frames = np.frombuffer(body, dtype="<f4").reshape(shape)
                    self._tensor(predictor.predict(sid, frames))
                elif path == "/v1/predict-batch":
                    sids_hdr = self.headers.get("X-Sessions")
                    if sids_hdr is None or self.headers.get("X-Shape") is None:
                        self._json(400, {"error": "predict-batch needs "
                                         "X-Sessions and X-Shape headers"})
                        return
                    sids = [v.strip() for v in sids_hdr.split(",")
                            if v.strip()]
                    shape = tuple(int(v) for v in
                                  self.headers["X-Shape"].split(","))
                    if len(shape) != 6 or shape[0] != len(sids):
                        self._json(400, {"error": "X-Shape must be "
                                         "N,B,T,H,W,C with N == number "
                                         "of X-Sessions ids"})
                        return
                    blocks = np.frombuffer(body, dtype="<f4").reshape(shape)
                    self._tensor(np.stack(predictor.predict_many(
                        sids, list(blocks))))
                else:
                    self._json(404, {"error": "not found"})
            except KeyError as e:
                # request fields are validated above: only an unknown
                # session raises KeyError
                self._json(404, {"error": str(e)})
            except (ValueError, TypeError) as e:   # JSONDecodeError included
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                # anything else is a server fault (kernel build, OOM, bad
                # checkpoint): 500 and the traceback for the operator
                import traceback
                traceback.print_exc()
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def do_DELETE(self):
            path, sid = self._route()
            if path.startswith("/v1/session/"):
                ok = predictor.close_session(sid)
                self._json(200 if ok else 404, {"closed": ok})
            else:
                self._json(404, {"error": "not found"})

    return Handler


def serve_http(predictor: StreamingPredictor, host: str = "127.0.0.1",
               port: int = 8000):
    """Returns a started ThreadingHTTPServer; the caller calls
    ``shutdown()`` and ``server_close()``."""
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer((host, port), _make_handler(predictor))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def run_server(checkpoint: str, host: str, port: int,
               warmup: Optional[Tuple[int, int, int]] = None,
               device=None, int8: bool = False,
               int8_calib_frames=None) -> None:
    predictor = StreamingPredictor(checkpoint, int8=int8, device=device,
                                   int8_calib_frames=int8_calib_frames)
    if predictor.int8_calib_blocks:
        print("int8: static activation scales calibrated "
              f"({predictor.int8_calib_blocks} frame blocks)")
    if warmup:
        print(f"warmup {warmup} ...")
        predictor.warmup(*warmup)
    server = serve_http(predictor, host, port)
    print(f"serving {checkpoint} on http://{host}:{port} "
          f"({predictor.device}, model {predictor.model_cfg.get('type', 'custom')})")
    try:
        threading.Event().wait()  # serve_http runs in a daemon thread
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
