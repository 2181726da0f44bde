"""OpenAI-compatible front door: ``/v1/completions`` + ``/v1/chat/completions``
(a copy of ``accelerate_tpu/serving/openai_api.py``: the same wire shapes,
so a client cannot tell the two packages' servers apart).

A pure translation layer between the OpenAI request/response shapes and the
engine's JSONL dialect — it owns NO sockets and NO engine: the host
(``serve --http`` or ``route --http``) hands it a ``submit(payload, cb)``
function and mounts :meth:`OpenAIFrontend.handle` on its POST paths. That
keeps the translation testable without a server and identical across the
single-engine and routed front ends.

Request mapping:

* ``temperature`` / ``top_p`` / ``seed`` / ``stop`` / ``logprobs`` /
  ``max_tokens`` → per-request :class:`~.sampling.SamplingParams` lanes
  (``temperature=0`` is greedy, like the OpenAI convention; the default
  ``temperature=1`` samples);
* ``response_format={"type": "json_schema", ...}`` → a :mod:`.grammar`
  constrained-decoding spec — every completion parses and validates;
* ``priority`` / ``deadline_ms`` / ``trace_id`` / ``tenant`` ride the
  vendor-prefixed extension fields ``x_accelerate_priority`` /
  ``x_accelerate_deadline_ms`` / ``x_accelerate_trace_id`` /
  ``x_accelerate_tenant``, so scheduling + tracing + usage-attribution
  machinery works through the standard surface (and the response carries
  an ``x_accelerate`` block with trace_id/ttft/tpot plus the request's
  measured costs — ``device_time_s``/``kv_block_seconds``/``swap_bytes``
  from the usage ledger);
* errors are OpenAI-shaped ``{"error": {message, type, param, code}}``
  objects with the right HTTP status.

Tokenization: the model zoo is byte-vocab (token id *i* is byte *i*), so
``prompt`` strings and chat messages encode as UTF-8 bytes and completions
decode the same way — token-id lists also pass straight through for
clients that pre-tokenize. The chat template is deliberately minimal
(``"role: content"`` lines + a trailing ``assistant:`` cue); the package
ships no tokenizer/template assets, and the golden tests pin the shape.

Streaming: ``stream=true`` answers Server-Sent Events. Behind ``serve``
the host wires a per-request delta callback (``streaming="delta"``) so
chunks flow as the engine emits tokens; behind ``route`` the replica
answers whole completions, so the front end replays the completion as one
chunk burst (``streaming="at_completion"``) — same framing, one
``data: [DONE]`` terminator, exactly-once either way.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import uuid

__all__ = ["OpenAIError", "OpenAIFrontend", "OPENAI_PATHS"]

#: POST paths the front end answers — hosts route these to handle()
OPENAI_PATHS = ("/v1/completions", "/v1/chat/completions")

#: request fields we accept but deliberately do not implement; a value
#: other than the OpenAI default is an explicit 400, never silence
_UNSUPPORTED_NON_DEFAULT = (
    ("n", 1), ("best_of", 1), ("echo", False), ("suffix", None),
    ("presence_penalty", 0), ("frequency_penalty", 0), ("logit_bias", None),
    ("tools", None), ("tool_choice", None), ("parallel_tool_calls", None),
)

#: engine finish_reasons with an exact OpenAI equivalent; anything else
#: (deadline_exceeded, out_of_blocks, ...) maps to "length" and the raw
#: reason rides the vendor block
_FINISH_MAP = {"eos": "stop", "stop": "stop", "length": "length"}


class OpenAIError(Exception):
    """A request refusal carrying its OpenAI error object + HTTP status."""

    def __init__(self, message: str, status: int = 400,
                 type_: str = "invalid_request_error",
                 param: str | None = None, code: str | None = None):
        super().__init__(message)
        self.status = status
        self.body = {
            "error": {
                "message": message,
                "type": type_,
                "param": param,
                "code": code,
            }
        }


def encode_text(text: str) -> list[int]:
    """Byte-vocab tokenize: token id i is byte i (UTF-8)."""
    return list(text.encode("utf-8"))


def decode_tokens(tokens) -> str:
    return bytes(int(t) & 0xFF for t in tokens).decode("utf-8", "replace")


def chat_prompt(messages) -> str:
    """The minimal chat template (the package ships no template assets): one
    ``role: content`` line per message + the assistant cue."""
    if not isinstance(messages, list) or not messages:
        raise OpenAIError("messages must be a non-empty array", param="messages")
    lines = []
    for i, m in enumerate(messages):
        if not isinstance(m, dict) or not isinstance(m.get("role"), str):
            raise OpenAIError(
                f"messages[{i}] must be an object with a string 'role'",
                param="messages",
            )
        content = m.get("content")
        if not isinstance(content, str):
            raise OpenAIError(
                f"messages[{i}].content must be a string", param="messages"
            )
        lines.append(f"{m['role']}: {content}")
    lines.append("assistant:")
    return "\n".join(lines)


def _num(body, key, lo, hi, default):
    v = body.get(key, default)
    if v is None:
        v = default
    try:
        v = float(v)
    except (TypeError, ValueError):
        raise OpenAIError(f"{key} must be a number", param=key) from None
    if not lo <= v <= hi:
        raise OpenAIError(f"{key} must be in [{lo}, {hi}]", param=key)
    return v


def _stop_sequences(stop) -> tuple:
    if stop is None:
        return ()
    if isinstance(stop, str):
        stop = [stop]
    if not isinstance(stop, list) or len(stop) > 4:
        raise OpenAIError("stop must be a string or up to 4 strings", param="stop")
    out = []
    for s in stop:
        if not isinstance(s, str) or not s:
            raise OpenAIError("stop entries must be non-empty strings", param="stop")
        out.append(tuple(encode_text(s)))
    return tuple(out)


def _response_format_grammar(body) -> dict | None:
    rf = body.get("response_format")
    if rf is None:
        return None
    if not isinstance(rf, dict) or "type" not in rf:
        raise OpenAIError(
            "response_format must be an object with a 'type'",
            param="response_format",
        )
    kind = rf["type"]
    if kind == "text":
        return None
    if kind == "json_object":
        raise OpenAIError(
            "response_format type 'json_object' is not supported — use "
            "'json_schema' with an explicit schema (constrained decoding "
            "compiles the schema to a token DFA, and free-form JSON has no "
            "schema to compile)",
            param="response_format",
        )
    if kind != "json_schema":
        raise OpenAIError(
            f"unknown response_format type {kind!r}", param="response_format"
        )
    # OpenAI nests the schema under json_schema.schema; accept the flat
    # shorthand too so curl examples stay short
    spec = rf.get("json_schema", rf)
    schema = spec.get("schema") if isinstance(spec, dict) else None
    if not isinstance(schema, dict):
        raise OpenAIError(
            "response_format json_schema needs a 'schema' object "
            '({"type": "json_schema", "json_schema": {"schema": {...}}})',
            param="response_format",
        )
    return {"type": "json_schema", "schema": schema}


class OpenAIFrontend:
    """Translate OpenAI requests into engine payloads and back.

    ``submit(payload, cb)`` enqueues one engine-dialect request; ``cb``
    fires exactly once with the result row (the serve/route answer shape:
    ``tokens``/``finish_reason``/``prompt_tokens``/``ttft_s``/... or
    ``error``). With ``streaming="delta"`` the host's engine loop honours
    a ``_stream`` callable in the payload by calling it with each new
    token chunk as decode emits them."""

    def __init__(self, submit, model: str = "accelerate-tpu",
                 streaming: str = "delta"):
        if streaming not in ("delta", "at_completion"):
            raise ValueError(f"unknown streaming mode {streaming!r}")
        self._submit = submit
        self.model = model
        self.streaming = streaming

    # -- request parsing -----------------------------------------------------

    def _payload_from(self, body: dict, prompt_tokens: list[int]) -> dict:
        """The shared field mapping (everything but prompt extraction)."""
        for key, default in _UNSUPPORTED_NON_DEFAULT:
            if key in body and body[key] not in (None, default):
                raise OpenAIError(
                    f"{key}={body[key]!r} is not supported (only the default "
                    f"{default!r})", param=key,
                )
        temperature = _num(body, "temperature", 0.0, 2.0, 1.0)
        top_p = _num(body, "top_p", 0.0, 1.0, 1.0)
        sampling: dict = {}
        if temperature == 0.0:
            sampling["do_sample"] = False  # the OpenAI greedy convention
        else:
            sampling["do_sample"] = True
            sampling["temperature"] = temperature
            if top_p < 1.0:
                sampling["top_p"] = top_p
        if body.get("seed") is not None:
            try:
                sampling["seed"] = int(body["seed"])
            except (TypeError, ValueError):
                raise OpenAIError("seed must be an integer", param="seed") from None
        stop = _stop_sequences(body.get("stop"))
        if stop:
            sampling["stop"] = [list(s) for s in stop]
        payload = {"prompt": prompt_tokens, "sampling": sampling}
        grammar = _response_format_grammar(body)
        if grammar is not None:
            payload["grammar"] = grammar
        if body.get("max_tokens") is not None:
            try:
                mnt = int(body["max_tokens"])
            except (TypeError, ValueError):
                raise OpenAIError(
                    "max_tokens must be an integer", param="max_tokens"
                ) from None
            if mnt < 1:
                raise OpenAIError("max_tokens must be >= 1", param="max_tokens")
            payload["max_new_tokens"] = mnt
        # vendor extension fields: the scheduling, tracing and usage knobs
        if body.get("x_accelerate_priority") is not None:
            payload["priority"] = body["x_accelerate_priority"]
        if body.get("x_accelerate_deadline_ms") is not None:
            payload["deadline_ms"] = body["x_accelerate_deadline_ms"]
        if body.get("x_accelerate_trace_id") is not None:
            payload["trace_id"] = body["x_accelerate_trace_id"]
        if body.get("x_accelerate_tenant") is not None:
            payload["tenant"] = body["x_accelerate_tenant"]
        return payload

    def _parse(self, path: str, body) -> tuple[dict, dict]:
        if not isinstance(body, dict):
            raise OpenAIError("request body must be a JSON object")
        chat = path.rstrip("/") == "/v1/chat/completions"
        if chat:
            prompt_tokens = encode_text(chat_prompt(body.get("messages")))
            logprobs = 0
            if body.get("logprobs"):
                logprobs = int(body.get("top_logprobs") or 1)
        else:
            prompt = body.get("prompt")
            if isinstance(prompt, str):
                prompt_tokens = encode_text(prompt)
            elif (
                isinstance(prompt, list)
                and prompt
                and all(isinstance(t, int) for t in prompt)
            ):
                prompt_tokens = prompt
            else:
                raise OpenAIError(
                    "prompt must be a string or a list of token ids",
                    param="prompt",
                )
            logprobs = body.get("logprobs") or 0
            try:
                logprobs = int(logprobs)
            except (TypeError, ValueError):
                raise OpenAIError(
                    "logprobs must be an integer", param="logprobs"
                ) from None
        payload = self._payload_from(body, prompt_tokens)
        if logprobs:
            payload["sampling"]["logprobs"] = logprobs
        meta = {
            "chat": chat,
            "stream": bool(body.get("stream")),
            "model": body.get("model") or self.model,
            "prompt_tokens": len(prompt_tokens),
            "logprobs": logprobs,
        }
        return payload, meta

    # -- response building ---------------------------------------------------

    @staticmethod
    def _finish(result: dict) -> tuple[str, str | None]:
        raw = result.get("finish_reason")
        mapped = _FINISH_MAP.get(raw)
        if mapped is not None:
            return mapped, None
        return "length", raw  # over-budget/expired: raw reason rides vendor

    @staticmethod
    def _vendor(result: dict, raw_finish: str | None) -> dict:
        out = {}
        for key in (
            "trace_id", "ttft_s", "tpot_s",
            # usage-ledger costs: what THIS request spent (measured, not
            # estimated — absent on usage_accounting=False engines)
            "tenant", "device_time_s", "kv_block_seconds", "swap_bytes",
        ):
            if result.get(key) is not None:
                out[key] = result[key]
        if raw_finish is not None:
            out["finish_reason"] = raw_finish
        return out

    @staticmethod
    def _logprobs_block(result: dict, meta: dict) -> dict | None:
        rows = result.get("logprobs")
        if not meta["logprobs"] or rows is None:
            return None
        if meta["chat"]:
            return {
                "content": [
                    {
                        "token": decode_tokens([e["token"]]),
                        "logprob": e["logprob"],
                        "top_logprobs": [
                            {"token": decode_tokens([t]), "logprob": lp}
                            for t, lp in e["top"]
                        ],
                    }
                    for e in rows
                ]
            }
        offsets, pos = [], 0
        texts = [decode_tokens([e["token"]]) for e in rows]
        for t in texts:
            offsets.append(pos)
            pos += len(t)
        return {
            "tokens": texts,
            "token_logprobs": [e["logprob"] for e in rows],
            "top_logprobs": [
                {decode_tokens([t]): lp for t, lp in e["top"]} for e in rows
            ],
            "text_offset": offsets,
        }

    def _completion_body(self, result: dict, meta: dict, rid: str,
                         created: int) -> dict:
        finish, raw = self._finish(result)
        tokens = result.get("tokens") or []
        usage = {
            "prompt_tokens": result.get("prompt_tokens", meta["prompt_tokens"]),
            "completion_tokens": len(tokens),
        }
        usage["total_tokens"] = usage["prompt_tokens"] + usage["completion_tokens"]
        choice: dict = {"index": 0, "finish_reason": finish,
                       "logprobs": self._logprobs_block(result, meta)}
        if meta["chat"]:
            choice["message"] = {
                "role": "assistant", "content": decode_tokens(tokens),
            }
        else:
            choice["text"] = decode_tokens(tokens)
        out = {
            "id": rid,
            "object": "chat.completion" if meta["chat"] else "text_completion",
            "created": created,
            "model": meta["model"],
            "choices": [choice],
            "usage": usage,
        }
        vendor = self._vendor(result, raw)
        if vendor:
            out["x_accelerate"] = vendor
        return out

    def _chunk_body(self, meta: dict, rid: str, created: int, *,
                    text=None, role=None, finish=None, usage=None,
                    vendor=None) -> dict:
        delta: dict = {}
        if role is not None:
            delta["role"] = role
        if text is not None:
            delta["content" if meta["chat"] else "text"] = text
        choice = {"index": 0, "finish_reason": finish}
        if meta["chat"]:
            choice["delta"] = delta
        else:
            choice["text"] = text or ""
            choice["logprobs"] = None
        out = {
            "id": rid,
            "object": (
                "chat.completion.chunk" if meta["chat"] else "text_completion"
            ),
            "created": created,
            "model": meta["model"],
            "choices": [choice],
        }
        if usage is not None:
            out["usage"] = usage
        if vendor:
            out["x_accelerate"] = vendor
        return out

    # -- the entry point -----------------------------------------------------

    def handle(self, path: str, body):
        """Answer one POST. Returns ``("json", status, obj)`` or
        ``("sse", iterator)`` — the iterator yields complete
        ``data: ...\\n\\n`` SSE event strings, ending with the
        ``data: [DONE]`` terminator."""
        try:
            payload, meta = self._parse(path, body)
        except OpenAIError as e:
            return ("json", e.status, e.body)
        rid = ("chatcmpl-" if meta["chat"] else "cmpl-") + uuid.uuid4().hex[:24]
        created = int(time.time())
        if not meta["stream"]:
            done = threading.Event()
            answer: dict = {}

            def cb(result):
                answer["result"] = result
                done.set()

            self._submit(payload, cb)
            done.wait()
            result = answer["result"]
            if "error" in result:
                err = OpenAIError(str(result["error"]), status=400)
                return ("json", err.status, err.body)
            return ("json", 200, self._completion_body(result, meta, rid, created))

        # streaming: deltas (and the final row) land in one queue; the
        # returned generator drains it from the host's handler thread
        q: queue.Queue = queue.Queue()
        if self.streaming == "delta":
            payload["_stream"] = lambda toks: q.put(("delta", list(toks)))
        self._submit(payload, lambda result: q.put(("done", result)))

        def events():
            served = 0
            sent_role = False
            while True:
                kind, item = q.get()
                if kind == "delta":
                    chunk_kw = {}
                    if meta["chat"] and not sent_role:
                        chunk_kw["role"] = "assistant"
                        sent_role = True
                    yield "data: " + json.dumps(self._chunk_body(
                        meta, rid, created, text=decode_tokens(item), **chunk_kw
                    )) + "\n\n"
                    served += len(item)
                    continue
                result = item
                if "error" in result:
                    err = OpenAIError(str(result["error"]), status=400)
                    yield "data: " + json.dumps(err.body) + "\n\n"
                    yield "data: [DONE]\n\n"
                    return
                finish, raw = self._finish(result)
                tokens = result.get("tokens") or []
                tail = tokens[served:]
                usage = {
                    "prompt_tokens": result.get(
                        "prompt_tokens", meta["prompt_tokens"]
                    ),
                    "completion_tokens": len(tokens),
                }
                usage["total_tokens"] = (
                    usage["prompt_tokens"] + usage["completion_tokens"]
                )
                chunk_kw = {}
                if meta["chat"] and not sent_role:
                    chunk_kw["role"] = "assistant"
                yield "data: " + json.dumps(self._chunk_body(
                    meta, rid, created,
                    text=decode_tokens(tail) if tail else None,
                    finish=finish, usage=usage,
                    vendor=self._vendor(result, raw), **chunk_kw
                )) + "\n\n"
                yield "data: [DONE]\n\n"
                return

        return ("sse", events())
