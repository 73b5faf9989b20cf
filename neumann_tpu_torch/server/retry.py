"""Retry with exponential backoff for SDK calls.

Parity with neumann-py/src/neumann/retry.py: a RetryConfig with
exponential backoff + jitter, retrying only transient transport
failures (UNAVAILABLE / DEADLINE_EXCEEDED / RESOURCE_EXHAUSTED), never
application errors.

The port's copy of ``neumann_tpu/server/retry.py``, unchanged.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Tuple, TypeVar

T = TypeVar("T")

_TRANSIENT = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED")


@dataclass(frozen=True)
class RetryConfig:
    max_retries: int = 3
    initial_backoff_s: float = 0.1
    max_backoff_s: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.1                  # +- fraction of the delay
    retryable_codes: Tuple[str, ...] = _TRANSIENT


def is_retryable(exc: Exception, config: RetryConfig) -> bool:
    code = getattr(exc, "code", None)
    if callable(code):
        try:
            code = code()
        except Exception:
            return False
        name = getattr(code, "name", str(code))
        return name in config.retryable_codes
    return False


def backoff_delay(attempt: int, config: RetryConfig) -> float:
    d = min(config.initial_backoff_s * config.multiplier ** attempt,
            config.max_backoff_s)
    return d * (1.0 + random.uniform(-config.jitter, config.jitter))


def retry_call(fn: Callable[[], T], config: RetryConfig) -> T:
    """Call fn, retrying transient transport errors with backoff."""
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — filtered by is_retryable
            if attempt >= config.max_retries or not is_retryable(e,
                                                                 config):
                raise
            time.sleep(backoff_delay(attempt, config))
            attempt += 1


async def retry_call_async(fn, config: RetryConfig):
    """Async variant: fn is a zero-arg coroutine factory."""
    import asyncio

    attempt = 0
    while True:
        try:
            return await fn()
        except Exception as e:  # noqa: BLE001
            if attempt >= config.max_retries or not is_retryable(e,
                                                                 config):
                raise
            await asyncio.sleep(backoff_delay(attempt, config))
            attempt += 1
