"""Wire protocol for the streaming frontend (docs/streaming_serving.md): a
copy of src/repro/serving/frontend/protocol.py, byte for byte on the wire.

OpenAI-style ``/v1/completions`` JSON in, dLLM-native SSE events out.  The
reproduction has no tokenizer, so "text" on the wire is the token-id
string (space-joined ints) and prompts are token-id lists; the streaming
unit is the per-tick commit *set* (``block_committed``), because dLLM
tokens unmask confidence-ordered within a block, not left-to-right.

SSE event schema (one ``event:``/``data:`` pair per engine tick):

  block_committed  {uid, tick, block_idx, step_in_block,
                    positions: [int], tokens: [int], masks_left}
  done             {id, object, model, choices: [{text, token_ids, index,
                    finish_reason}], usage, ticks, ttft_s, latency_s}
  error            {error: {type, message}}   (e.g. type=overloaded on a
                                               post-accept queue-wait shed)

followed by the literal ``data: [DONE]`` terminator.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.obs import slo as slo_lib


class BadRequest(ValueError):
    """Client error: malformed/unsatisfiable completion body (HTTP 400)."""


def detok(tokens) -> str:
    """Token ids -> wire text.  No tokenizer in the repro: the canonical
    text form is the space-joined id string (bit-exact round-trip)."""
    return " ".join(str(int(t)) for t in np.asarray(tokens).reshape(-1))


def entok(text: str) -> np.ndarray:
    """Wire text -> token ids (inverse of :func:`detok`)."""
    parts = text.split()
    try:
        return np.array([int(p) for p in parts], np.int32)
    except ValueError:
        raise BadRequest(f"prompt string must be space-joined token ids, "
                         f"got {text[:40]!r}")


def parse_completion(body: dict, *, block_length: int, max_seq_len: int,
                     vocab: int) -> Tuple[np.ndarray, int, bool]:
    """Validate a ``/v1/completions`` body -> (prompt ids, gen_length,
    stream).  Raises :class:`BadRequest` with a client-actionable message.
    """
    if not isinstance(body, dict):
        raise BadRequest("body must be a JSON object")
    prompt = body.get("prompt")
    if isinstance(prompt, str):
        ids = entok(prompt)
    elif isinstance(prompt, (list, tuple)):
        try:
            ids = np.array([int(t) for t in prompt], np.int32)
        except (TypeError, ValueError):
            raise BadRequest("prompt list must contain only ints")
    else:
        raise BadRequest("prompt must be a token-id list or a space-joined "
                         "id string")
    if ids.size == 0:
        raise BadRequest("prompt must be non-empty")
    if int(ids.min()) < 0 or int(ids.max()) >= vocab:
        raise BadRequest(f"prompt ids must be in [0, {vocab})")
    max_tokens = body.get("max_tokens", block_length)
    if not isinstance(max_tokens, int) or max_tokens <= 0 \
            or max_tokens % block_length:
        raise BadRequest(
            f"max_tokens must be a positive multiple of the engine "
            f"block_length ({block_length}); got {max_tokens!r}")
    if ids.size + max_tokens > max_seq_len:
        raise BadRequest(
            f"prompt ({ids.size}) + max_tokens ({max_tokens}) exceeds the "
            f"engine max_seq_len ({max_seq_len})")
    stream = bool(body.get("stream", False))
    return ids, max_tokens, stream


def parse_policy(body: dict) -> Tuple[Optional[str], Optional[dict]]:
    """Validate the optional per-request ``policy`` + ``policy_params``
    fields of a completion body -> (name, params).  Raises
    :class:`BadRequest` for unknown names or parameters the policy's
    constructor rejects (validated here so clients get a 400, not a
    worker-thread rejection)."""
    name = body.get("policy")
    params = body.get("policy_params")
    if name is None:
        if params is not None:
            raise BadRequest("policy_params requires a policy name")
        return None, None
    if not isinstance(name, str):
        raise BadRequest(f"policy must be a string, got {name!r}")
    if params is not None and not isinstance(params, dict):
        raise BadRequest(f"policy_params must be an object, got {params!r}")
    from repro_torch.serving.scheduler import get_policy
    try:
        get_policy(name, **(params or {}))
    except (TypeError, ValueError) as e:
        raise BadRequest(f"invalid policy {name!r}: {e}")
    return name, params


def parse_slo_class(body: dict,
                    classes: Optional[Dict] = None) -> str:
    """Validate the optional ``slo_class`` field of a completion body.
    Unknown class names are a client error (400) — silently downgrading a
    request's tier would hide misconfigured clients from the violation
    accounting."""
    name = body.get("slo_class", slo_lib.DEFAULT_CLASS)
    if not isinstance(name, str) or not name:
        raise BadRequest(f"slo_class must be a non-empty string, "
                         f"got {name!r}")
    if classes is not None and name not in classes:
        raise BadRequest(f"unknown slo_class {name!r}; choose from "
                         f"{sorted(classes)}")
    return name


# -- W3C trace context (docs/observability.md) ------------------------------
#
# One trace id per request links the client's log line, the structured
# event log, the Perfetto async request span, and the /metrics exemplar.
# The header is the W3C traceparent form: 00-<32hex trace>-<16hex span>-
# <2hex flags>; the frontend accepts a client-minted one or mints its own.

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def mint_trace_id() -> str:
    return os.urandom(16).hex()


def mint_span_id() -> str:
    return os.urandom(8).hex()


def parse_traceparent(header: Optional[str]) -> Optional[str]:
    """Extract the trace id from a ``traceparent`` header, or None when
    absent/malformed/all-zero (the spec's invalid values) — the caller
    then mints a fresh id rather than failing the request."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id


def format_traceparent(trace_id: str, span_id: Optional[str] = None,
                       flags: str = "01") -> str:
    return f"00-{trace_id}-{span_id or mint_span_id()}-{flags}"


# -- response payloads ------------------------------------------------------

def commit_payload(ev) -> dict:
    """CommitEvent -> ``block_committed`` JSON payload."""
    return {
        "uid": int(ev.uid),
        "tick": int(ev.tick),
        "block_idx": int(ev.block_idx),
        "step_in_block": int(ev.step_in_block),
        "positions": [int(p) for p in ev.positions],
        "tokens": [int(t) for t in ev.tokens],
        "masks_left": int(ev.masks_left),
    }


def completion_payload(uid: int, model: str, prompt_len: int,
                       final_tokens: np.ndarray, ticks: int,
                       ttft_s: Optional[float],
                       latency_s: float,
                       trace_id: Optional[str] = None) -> dict:
    """Final (``done`` / non-streaming) OpenAI-style completion object.
    ``trace_id`` (when the frontend runs with trace context) lets clients
    join the response to the event log / Perfetto trace."""
    completion = np.asarray(final_tokens)[prompt_len:]
    out = {
        "id": f"cmpl-{uid}",
        "object": "text_completion",
        "model": model,
        "choices": [{
            "index": 0,
            "text": detok(completion),
            "token_ids": [int(t) for t in completion],
            "finish_reason": "stop",
        }],
        "usage": {
            "prompt_tokens": int(prompt_len),
            "completion_tokens": int(completion.size),
            "total_tokens": int(prompt_len + completion.size),
        },
        "ticks": int(ticks),
        "ttft_s": None if ttft_s is None else float(ttft_s),
        "latency_s": float(latency_s),
    }
    if trace_id is not None:
        out["trace_id"] = trace_id
    return out


def error_payload(err_type: str, message: str) -> dict:
    return {"error": {"type": err_type, "message": message}}


# -- SSE / HTTP framing -----------------------------------------------------

def sse_event(name: str, payload: dict) -> bytes:
    return (f"event: {name}\ndata: {json.dumps(payload)}\n\n"
            ).encode("utf-8")


SSE_DONE = b"data: [DONE]\n\n"

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable"}


def http_response(status: int, body: bytes,
                  content_type: str = "application/json",
                  headers: Optional[Dict[str, str]] = None) -> bytes:
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"{extra}"
            f"Connection: close\r\n\r\n")
    return head.encode("utf-8") + body


def json_response(status: int, payload: dict,
                  headers: Optional[Dict[str, str]] = None) -> bytes:
    return http_response(status, json.dumps(payload).encode("utf-8"),
                         headers=headers)


def sse_headers(headers: Optional[Dict[str, str]] = None) -> bytes:
    """Response head for a streaming reply; events follow unframed (the
    connection closes after ``data: [DONE]``, so no chunked encoding)."""
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    return (b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            + extra.encode("utf-8")
            + b"Connection: close\r\n\r\n")
