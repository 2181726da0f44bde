"""Big-model inference: meta init, device-map dispatch and weights tiered
over HBM, host DRAM and disk (port of ``accelerate_tpu/big_modeling.py``).

* :func:`init_empty_weights` builds a model's parameters on the meta
  device: shapes and dtypes, no bytes, no random draw.
* A device map assigns parameter-name prefixes to tiers: a card (an int;
  on a CPU run, the CPU), ``"cpu"`` (host DRAM, pinned once at dispatch
  when the model runs on a card) or ``"disk"`` (one ``.dat`` file a tensor,
  ``utils/offload.py``). Each layer is its own submodule here, so a map
  may put any layer on any tier.
* :func:`dispatch_model` returns a :class:`DispatchedModel`. A model with
  a segment plan (``model.segments(...)``: embed, one step a layer, norm
  and head) streams it: while segment i computes, segment i+1 is copied
  host-to-device on a side CUDA stream and segment i+2 is read off disk
  into a two-slot pinned staging ring, by two worker threads. The compute
  stream waits on the copy's event before it runs segment i+1, and a
  staging slot is refilled only after the event of the copies that read
  it; device buffers are allocated on the copy stream and
  ``record_stream``-ed on the compute stream, so none is reused while a
  segment that reads it may still run. On the CPU the same tiers and
  workers run without streams. A model without segments is materialised
  on the execution device for the call, then applied.

Quantized weights (``utils/quantization.py``) stream as their int8 or
4-bit planes; a 4-bit weight's indices are decoded to int8 codes on the
host by the native decoder (``native/``) into the staging ring, and the
layer's products run on int8 (``ops.fp8.dense``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Mapping

import numpy as np
import torch

from .logging import get_logger
from .utils.device import resolve_device
from .utils.modeling import (
    find_tied_parameters,
    flat_param_shapes,
    get_balanced_memory,
    infer_auto_device_map,
    load_state_dict_from_files,
)
from .utils.offload import OffloadedWeightsLoader, offload_state_dict
from .utils.quantization import (
    Q4DecodedTensor,
    Q4Tensor,
    QTensor,
    _owner,
    dequantize_tree,
    is_quantized,
    quantized_planes,
)

logger = get_logger(__name__)

__all__ = ["init_empty_weights", "init_on_device", "is_empty_init",
           "dispatch_model", "DispatchedModel", "cpu_offload", "disk_offload",
           "load_checkpoint_in_model", "load_checkpoint_and_dispatch"]

_EMPTY_INIT = {"active": False, "include_buffers": True, "device": None}


@contextlib.contextmanager
def init_empty_weights(include_buffers: bool = True):
    """Build models inside the block with their parameters on the meta
    device: no memory, no random draw (the zoo's constructors and
    ``from_config`` consult :func:`is_empty_init`). The zoo's buffers are
    tables computed from the config (RoPE), built on the host whatever
    ``include_buffers`` says; dispatch moves them to the execution device."""
    old = dict(_EMPTY_INIT)
    _EMPTY_INIT.update(active=True, include_buffers=include_buffers)
    try:
        yield
    finally:
        _EMPTY_INIT.update(old)


@contextlib.contextmanager
def init_on_device(device):
    """Models built inside the block default to ``device``; ``"meta"`` is
    :func:`init_empty_weights`."""
    if device is None or torch.device(device).type == "meta":
        with init_empty_weights():
            yield
        return
    old = _EMPTY_INIT["device"]
    _EMPTY_INIT["device"] = torch.device(device)
    try:
        yield
    finally:
        _EMPTY_INIT["device"] = old


def is_empty_init() -> bool:
    return _EMPTY_INIT["active"]


def init_device(device=None) -> torch.device:
    """Where a model's constructor puts its parameters: meta under
    :func:`init_empty_weights`, :func:`init_on_device`'s device when the
    caller names none, else ``resolve_device(device)``."""
    if _EMPTY_INIT["active"]:
        return torch.device("meta")
    if device is None and _EMPTY_INIT["device"] is not None:
        device = _EMPTY_INIT["device"]
    return resolve_device(device)


def set_module_tensor(model: torch.nn.Module, name: str, value: torch.Tensor) -> None:
    """Put ``value`` in place of parameter or buffer ``name`` (a parameter
    stays a frozen ``nn.Parameter``)."""
    module, leaf = _owner(model, name)
    if leaf in module._parameters:
        module._parameters[leaf] = torch.nn.Parameter(value, requires_grad=False)
    else:
        module._buffers[leaf] = value


def materialize_params(model: torch.nn.Module, init_fn: Callable | None = None, seed: int = 0,
                       device=None) -> torch.nn.Module:
    """Give a meta-built model real parameters on ``device``: the state
    dict ``init_fn(generator)`` draws (e.g. a family's ``init_*_params``
    with its config bound) when given, else zeros (values are meaningless
    until a checkpoint loads, as the reference's meta→empty)."""
    device = resolve_device(device)
    for name, p in list(model.named_parameters()):
        if p.is_meta:
            set_module_tensor(model, name, torch.zeros(p.shape, dtype=p.dtype, device=device))
    for name, b in list(model.named_buffers()):
        set_module_tensor(model, name, b.to(device))
    if init_fn is not None:
        state = init_fn(torch.Generator(device=device).manual_seed(seed))
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name in state:
                    p.copy_(state[name])
    return model


# ---------------------------------------------------------------------------
# tier placement
# ---------------------------------------------------------------------------


_UNMAPPED = object()


def _entry_for(path: str, device_map: Mapping[str, Any], default=_UNMAPPED):
    """Longest-prefix device-map lookup for a dot path."""
    probe = path
    while True:
        if probe in device_map:
            return device_map[probe]
        if "." not in probe:
            break
        probe = probe.rsplit(".", 1)[0]
    if "" in device_map:
        return device_map[""]
    return default


class TieredParams:
    """A model's tensors split across tiers, by flat name (a quantized
    weight by its planes' names, ``<name>.q`` ...): ``resident`` on the
    execution device, ``host`` (pinned when that device is a card) and the
    disk store."""

    def __init__(self, resident: dict, host: dict, disk_index: Mapping | None,
                 offload_dir: str | None):
        self.resident = resident
        self.host = host
        self.disk = (OffloadedWeightsLoader(save_folder=offload_dir)
                     if disk_index is not None else None)

    def fetch_host_or_disk(self, path: str) -> torch.Tensor:
        """A host tensor, or a disk tensor mapping its file's pages."""
        if path in self.host:
            return self.host[path]
        if self.disk is not None and path in self.disk:
            return self.disk[path]
        raise KeyError(path)

    @property
    def resident_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.resident.values())


def _flat_state(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's dense parameters and its quantized weights' planes, by
    flat name."""
    quantized = getattr(model, "quantized_weights", {})
    flat = {n: p.detach() for n, p in model.named_parameters() if n not in quantized}
    flat.update(quantized_planes(quantized))
    return flat


def dispatch_model(
    model: torch.nn.Module,
    device_map: Mapping[str, Any],
    main_device=None,
    state_dict: Mapping | None = None,
    offload_dir: str | None = None,
    offload_buffers: bool = False,
    skip_keys=None,
    preload_module_classes=None,
    force_hooks: bool = False,
) -> "DispatchedModel":
    """Place a model's tensors by ``device_map`` and return a
    :class:`DispatchedModel` that runs on ``main_device`` (the card unless
    the caller names the CPU). The model's buffers move to that device. A
    meta parameter (never loaded) is placed as zeros."""
    device = resolve_device(main_device)
    on_card = device.type == "cuda"
    resident, host, to_disk, unmapped = {}, {}, {}, []
    for key, value in _flat_state(model).items():
        tier = _entry_for(key, device_map)
        if tier is _UNMAPPED:
            unmapped.append(key)
            continue
        if value.is_meta:
            value = torch.zeros(value.shape, dtype=value.dtype)
        if tier == "cpu":
            value = value.cpu().contiguous()
            host[key] = value.pin_memory() if on_card else value
        elif tier == "disk":
            to_disk[key] = value
        else:
            resident[key] = value.to(torch.device("cuda", int(tier)) if on_card else device)
    if unmapped:
        raise ValueError(f"device_map does not cover {len(unmapped)} parameters "
                         f"(e.g. {unmapped[:3]}); add entries or a '' catch-all")
    disk_index = None
    if to_disk:
        if offload_dir is None:
            raise ValueError("device_map sends weights to 'disk' but no offload_dir given")
        disk_index = offload_state_dict(offload_dir, to_disk)
    for name, b in list(model.named_buffers()):
        set_module_tensor(model, name, b.to(device))
    tiered = TieredParams(resident, host, disk_index, offload_dir)
    return DispatchedModel(model, tiered, device_map, device)


_STATS = {"bytes_h2d": 0, "io_s": 0.0, "decode_s": 0.0}

#: a quantized weight's planes, by kind
_PLANES = {"qt": QTensor.PLANES, "q4": Q4Tensor.PLANES}


class DispatchedModel:
    """A model over tiered weights (see the module docstring). Call it as
    the model; ``hf_device_map`` is the map it was dispatched with.

    Counters: ``calls``, ``dequantize_retries`` (segments of a model that
    did not take quantized weights and ran them dequantized: never a zoo
    segment), and with ``timing = True`` the per-call report of
    :meth:`stream_report`."""

    def __init__(self, model: torch.nn.Module, tiered: TieredParams, device_map,
                 device: torch.device):
        self._model = model
        self.tiered = tiered
        self.hf_device_map = dict(device_map)
        self.device = device
        self.calls = 0
        self.dequantize_retries = 0
        self.timing = False
        self._dequantized_keys: set = set()
        self._io_executor = None     # stage 1: host and disk reads into the staging ring
        self._place_executor = None  # stage 2: 4-bit decode and the copies to the card
        self._slots: list = [None, None]
        self._slot_events: dict = {}
        self._copy_stream = None
        #: sums since the last :meth:`stream_report`: bytes copied to the card
        #: (place worker), host seconds of the reads (IO worker) and of the
        #: 4-bit decode
        self.stats = dict(_STATS)
        self._events: list = []  # (kind, start event, end event) with ``timing`` on
        quantized = getattr(model, "quantized_weights", {})
        self._kinds = {n: "qt" if isinstance(q, QTensor) else "q4" for n, q in quantized.items()}
        #: each 4-bit weight's codebook on the int8 grid, for the host decoder
        self._luts = {n: np.round(q.code.cpu().numpy() * 127.0).astype(np.int8)
                      for n, q in quantized.items() if isinstance(q, Q4Tensor)}

    # -- what the model exposes ------------------------------------------------

    @property
    def config(self):
        return getattr(self._model, "config", None)

    @property
    def is_encoder_decoder(self) -> bool:
        return bool(getattr(self._model, "is_encoder_decoder", False))

    def unwrap(self) -> torch.nn.Module:
        return self._model

    def close(self):
        """Release the two workers and the pinned staging ring."""
        for attr in ("_io_executor", "_place_executor"):
            ex = getattr(self, attr, None)
            if ex is not None:
                ex.shutdown(wait=False, cancel_futures=True)
                setattr(self, attr, None)
        self._slots = [None, None]

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args, **kwargs):
        """The model's forward over the tiered weights; tensor and numpy
        arguments move to the execution device."""
        args = tuple(self._on_device(a) for a in args)
        kwargs = {k: self._on_device(v) for k, v in kwargs.items()}
        self.calls += 1
        with torch.no_grad():
            segments = getattr(self._model, "segments", None)
            if segments is not None:
                return self._call_streaming(segments, *args, **kwargs)
            return self._call_materialized(*args, **kwargs)

    def _on_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.as_tensor(x)
        return x.to(self.device) if isinstance(x, torch.Tensor) else x

    # -- the generic path ----------------------------------------------------

    def _weight(self, path: str):
        """One weight on the execution device, dense or quantized."""
        kind = self._kinds.get(path, "dense")
        if kind == "dense":
            return self._fetch(path, to_device=True)
        planes = {p: self._fetch(f"{path}.{p}", to_device=True) for p in _PLANES[kind]}
        return QTensor(**planes) if kind == "qt" else Q4Tensor(**planes)

    def _fetch(self, name: str, to_device: bool = False) -> torch.Tensor:
        if name in self.tiered.resident:
            return self.tiered.resident[name]
        t = self.tiered.fetch_host_or_disk(name)
        return t.to(self.device) if to_device else t

    def _call_materialized(self, *args, **kwargs):
        from .utils.quantization import call_with_weights

        model = self._model
        config = getattr(model, "quantization_config", None)
        dtype = config.compute_dtype if config is not None else torch.float32
        names = [n for n, _ in model.named_parameters()]
        weights = {n: self._weight(n) for n in names}
        weights = dequantize_tree(weights, dtype)
        return call_with_weights(model, weights, args, kwargs)

    # -- the streaming path --------------------------------------------------

    def _kind_planes(self, path: str) -> tuple[str, list[str]]:
        kind = self._kinds.get(path, "dense")
        return kind, [path] if kind == "dense" else [f"{path}.{p}" for p in _PLANES[kind]]

    def _slot(self, i: int, nbytes: int) -> torch.Tensor:
        """Segment i's pinned staging slot (i % 2), once the copies that
        read it last have finished."""
        s = i % 2
        event = self._slot_events.pop(s, None)
        if event is not None:
            event.synchronize()
        slot = self._slots[s]
        if slot is None or slot.numel() < nbytes:
            self._slots[s] = slot = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                                pin_memory=True)
        return slot

    def _segment_fetch_raw(self, i: int, paths) -> dict:
        """Stage 1 (IO worker): each weight of segment i as host or device
        material. On a card, disk tensors are read into the staging slot
        (the read pages them in) and the slot reserves room for the
        decoded codes of each 4-bit weight that is not resident."""
        t0 = time.perf_counter()
        on_card = self.device.type == "cuda"
        plan = []  # (path, kind, {plane: source}), the disk ones still to stage
        need = 0
        for path in paths:
            kind, names = self._kind_planes(path)
            planes = {}
            for name in names:
                if name in self.tiered.resident:
                    planes[name] = self.tiered.resident[name]
                    continue
                src = self.tiered.fetch_host_or_disk(name)
                if not (on_card and name in self.tiered.host):
                    need += _aligned(src.numel() * src.element_size())
                planes[name] = src
            if kind == "q4" and not planes[f"{path}.packed"].is_cuda:
                need += _aligned(planes[f"{path}.packed"].numel() * 2)
            plan.append((path, kind, planes))
        slot = self._slot(i, need) if on_card else None
        offset = 0
        out = {}
        for path, kind, planes in plan:
            for name, src in planes.items():
                if name in self.tiered.resident or name in self.tiered.host:
                    continue
                if slot is None:  # the CPU: a copy reads the disk pages now
                    planes[name] = src.clone()
                    continue
                nbytes = src.numel() * src.element_size()
                view = slot[offset:offset + nbytes].view(src.dtype).view(src.shape)
                view.copy_(src)
                planes[name] = view
                offset += _aligned(nbytes)
            codes = None
            if kind == "q4" and slot is not None and not planes[f"{path}.packed"].is_cuda:
                n = planes[f"{path}.packed"].numel() * 2
                codes = slot[offset:offset + n].view(torch.int8)
                offset += _aligned(n)
            out[path] = (kind, planes, codes)
        self.stats["io_s"] += time.perf_counter() - t0
        return out

    def _segment_place(self, i: int, raw: dict, after: "_Handoff | None" = None):
        """Stage 2 (place worker): 4-bit planes decoded to int8 codes on the
        host, then every non-resident tensor copied to the card on the copy
        stream, once segment i-2 has computed (``after``), so at most three
        segments' buffers live on the card; returns ``(segment weights, the
        copies' event or None)``."""
        from . import native

        on_card = self.device.type == "cuda"
        if after is not None:
            after.wait()
        seg = {}
        stream = self._copy_stream
        ctx = torch.cuda.stream(stream) if on_card else contextlib.nullcontext()
        timed = self.timing and on_card
        start = None
        nbytes = 0
        with ctx:
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)

            def put(t):
                nonlocal nbytes
                if not on_card or t.is_cuda:
                    return t
                d = torch.empty(t.shape, dtype=t.dtype, device=self.device)
                d.copy_(t, non_blocking=True)
                d.record_stream(self._compute_stream)
                nbytes += t.numel() * t.element_size()
                return d

            for path, (kind, planes, codes) in raw.items():
                p = {name.rsplit(".", 1)[-1] if kind != "dense" else "": v
                     for name, v in planes.items()}
                if kind == "dense":
                    seg[path] = put(p[""])
                elif kind == "qt":
                    seg[path] = QTensor(put(p["q"]), put(p["scale"]))
                else:
                    seg[path] = self._place_q4(path, p, codes, put, native)
            event = None
            if on_card:
                event = torch.cuda.Event(enable_timing=timed)
                event.record(stream)
                self._slot_events[i % 2] = event
        self.stats["bytes_h2d"] += nbytes
        if timed:
            self._events.append(("copy", start, event))
        return seg, event

    def _place_q4(self, path, p, codes, put, native):
        packed = p["packed"]
        scales = (put(p["scale_q"]), put(p["scale_offset"]), put(p["scale_scale"]))
        if not packed.is_cuda:
            out = None if codes is None else codes.numpy().reshape(
                *packed.shape[:-1], packed.shape[-1] * 2)
            t0 = time.perf_counter()
            c8 = native.q4_decode_codes(packed.numpy(), self._luts[path], out=out)
            self.stats["decode_s"] += time.perf_counter() - t0
            if c8 is not None:
                c8 = codes.view(out.shape) if codes is not None else torch.from_numpy(c8)
                return Q4DecodedTensor(put(c8), *scales)
        return Q4Tensor(put(packed), *scales, put(p["code"]))

    def _call_streaming(self, segments, *args, **kwargs):
        """Run the plan ``segments(*args, **kwargs)`` — ``{"init",
        "steps": [(name, weight paths, fn(weights, carry) -> carry)],
        "finalize"}`` — through the three stages (see the module
        docstring); steady-state a step takes max(read, copy, compute)."""
        plan = segments(*args, **kwargs)
        steps = plan["steps"]
        carry = plan["init"]()
        if self._io_executor is None:
            self._io_executor = ThreadPoolExecutor(max_workers=1,
                                                   thread_name_prefix="offload-fetch")
            self._place_executor = ThreadPoolExecutor(max_workers=1,
                                                      thread_name_prefix="offload-place")
        if self.device.type == "cuda":
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            self._compute_stream = torch.cuda.current_stream(self.device)
        futures: dict[int, Any] = {}
        # segment i's compute, handed to the place worker of segment i+2
        computed = [_Handoff() for _ in steps] if self.device.type == "cuda" else None

        def schedule(i: int) -> None:
            if i < len(steps) and i not in futures:
                raw = self._io_executor.submit(self._segment_fetch_raw, i, steps[i][1])
                raw.add_done_callback(lambda f: f.exception())
                after = computed[i - 2] if computed and i >= 2 else None
                futures[i] = self._place_executor.submit(
                    lambda r=raw, i=i, a=after: self._segment_place(i, r.result(), a))

        # lookahead depth 2: i computes, i+1 copies, i+2 reads
        schedule(0)
        schedule(1)
        try:
            for i, (name, _, fn) in enumerate(steps):
                seg, event = futures.pop(i).result()
                schedule(i + 2)
                carry = self._run_segment(name, fn, seg, carry, event)
                del seg
                if computed:
                    done = torch.cuda.Event()
                    done.record(self._compute_stream)
                    computed[i].set(done)
            return plan["finalize"](carry)
        finally:
            for handoff in computed or ():  # no place task waits on a failed step
                handoff.set(None)
            for fut in futures.values():  # a failed segment strands no prefetch
                if not fut.cancel():
                    fut.add_done_callback(lambda f: f.exception())

    def _run_segment(self, name, fn, seg, carry, event):
        timed = self.timing and event is not None
        if event is not None:
            self._compute_stream.wait_event(event)
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._compute_stream)
        key = name if isinstance(name, str) else name[0]
        if key in self._dequantized_keys:
            carry = fn(self._dequantized(seg), carry)
        else:
            try:
                carry = fn(seg, carry)
            except (TypeError, AttributeError) as first_err:
                # a segment function that is not the zoo's used an operation
                # the quantized weights do not take: run it on their
                # dequantized values from now on. A dense segment's error is
                # the caller's and stands.
                if not any(is_quantized(v) for v in seg.values()):
                    raise
                try:
                    carry = fn(self._dequantized(seg), carry)
                except (TypeError, AttributeError):
                    raise first_err from None
                self.dequantize_retries += 1
                self._dequantized_keys.add(key)
        if timed:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._compute_stream)
            self._events.append(("compute", start, end))
        return carry

    def _dequantized(self, seg: dict) -> dict:
        config = getattr(self._model, "quantization_config", None)
        return dequantize_tree(seg, config.compute_dtype if config is not None else torch.float32)

    # -- measurement -----------------------------------------------------------

    def stream_report(self) -> dict:
        """:attr:`stats` and the copy stream's and the compute stream's ms
        over the segments (CUDA events, with ``timing`` on), summed since the
        last report, which this one starts anew. Synchronises the card."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = dict(self.stats, copy_ms=0.0, compute_ms=0.0, segments=0)
        for kind, start, end in self._events:
            out[f"{kind}_ms"] += start.elapsed_time(end)
            out["segments"] += kind == "compute"
        self._events = []
        self.stats = dict(_STATS)
        return out


class _Handoff:
    """A CUDA event handed from the compute loop to the place worker, which
    waits for it to be recorded and then for the card to pass it."""

    def __init__(self):
        self._ready = threading.Event()
        self.event = None

    def set(self, event) -> None:
        if not self._ready.is_set():
            self.event = event
            self._ready.set()

    def wait(self) -> None:
        self._ready.wait()
        if self.event is not None:
            self.event.synchronize()


def _aligned(n: int, to: int = 256) -> int:
    return n + (-n % to)


# ---------------------------------------------------------------------------
# the reference's entry points
# ---------------------------------------------------------------------------


def cpu_offload(model: torch.nn.Module, execution_device=None, offload_buffers: bool = False,
                state_dict=None) -> DispatchedModel:
    """Every weight on the host, streamed a segment at a time."""
    return dispatch_model(model, {"": "cpu"}, main_device=execution_device)


def disk_offload(model: torch.nn.Module, offload_dir: str, execution_device=None,
                 offload_buffers: bool = False) -> DispatchedModel:
    """Every weight on disk under ``offload_dir``, streamed."""
    return dispatch_model(model, {"": "disk"}, main_device=execution_device,
                          offload_dir=offload_dir)


def load_checkpoint_in_model(
    model: torch.nn.Module,
    checkpoint: str,
    device_map: Mapping | None = None,
    offload_folder: str | None = None,
    dtype=None,
    offload_state_dict_flag: bool = False,
    strict: bool = False,
    key_map: Callable[[dict], dict] | None = None,
    main_device=None,
) -> torch.nn.Module:
    """Load a (possibly sharded, possibly HF-named) checkpoint into the
    model's parameters. With a ``device_map`` the values stay on the host
    (safetensors pages are mapped, not read, until dispatch places them);
    without one they go where the parameter lies, or to ``main_device``
    (the card by default) for a meta parameter. HF names are converted by
    ``key_map`` or the model's ``convert_state_dict`` when the checkpoint
    does not use the model's own names."""
    flat = load_state_dict_from_files(checkpoint)
    params = dict(model.named_parameters())
    if len(set(params) & set(flat)) < max(1, len(params) // 2):
        key_map = key_map or getattr(model, "convert_state_dict", None)
        if key_map is not None:
            flat = key_map(flat)
    keep_on_host = device_map is not None
    missing = []
    for name, p in params.items():
        target = torch.device("cpu") if keep_on_host else (
            resolve_device(main_device) if p.is_meta else p.device)
        if name in flat:
            value = flat[name]
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"checkpoint {name} has shape {tuple(value.shape)}, the model "
                                 f"{tuple(p.shape)}")
            value = value.to(dtype=dtype or p.dtype).to(target)
        else:
            missing.append(name)
            if strict:
                raise KeyError(f"checkpoint missing {name}")
            if not p.is_meta:
                continue
            value = torch.zeros(p.shape, dtype=p.dtype, device=target)
        set_module_tensor(model, name, value)
    if missing:
        logger.warning(f"{len(missing)} params not found in checkpoint (e.g. {missing[:3]})")
    return model


def load_checkpoint_and_dispatch(
    model: torch.nn.Module,
    checkpoint: str,
    device_map: Mapping | str | None = None,
    max_memory: Mapping | None = None,
    no_split_module_classes=None,
    offload_folder: str | None = None,
    offload_buffers: bool = False,
    dtype=None,
    offload_state_dict_flag: bool | None = None,
    skip_keys=None,
    preload_module_classes=None,
    force_hooks: bool = False,
    main_device=None,
):
    """Infer the device map (``"auto"`` / ``"balanced"``, over ``max_memory``),
    load the checkpoint and dispatch: the reference's one-call path."""
    if isinstance(device_map, str):
        shapes = flat_param_shapes(model)
        if device_map == "balanced":
            max_memory = get_balanced_memory(shapes, max_memory, no_split_module_classes,
                                             dtype=dtype)
        device_map = infer_auto_device_map(shapes, max_memory=max_memory,
                                           no_split_module_classes=no_split_module_classes,
                                           dtype=dtype,
                                           tied_parameters=find_tied_parameters(model))
    load_checkpoint_in_model(model, checkpoint, device_map=device_map,
                             offload_folder=offload_folder, dtype=dtype, main_device=main_device)
    if device_map is None:
        return model
    return dispatch_model(model, device_map, main_device=main_device, offload_dir=offload_folder)
