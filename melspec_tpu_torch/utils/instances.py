"""Config-keyed sharing of streaming frontend instances (port of
``melspec_tpu.utils.instances``).

``shared_instance`` returns ONE canonical instance per ``(class,
constructor args)`` key, so a deployment that constructs a frontend per
client, per reconnect or per source rate reuses one set of device
matrices instead of building a copy each time. Sharing is safe because the
streaming classes keep all per-stream state in the carried state tuples
(``FrontendState`` etc.), never on the instance.

Constructor arguments must be hashable (or dicts / lists / tuples of
hashables): the frozen config dataclasses, dtypes, ``torch.device``,
strings and ints all are. The cache holds at most one instance per
distinct configuration.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, TypeVar

T = TypeVar("T")

_lock = threading.Lock()
_cache: dict = {}


def _freeze(value: Any) -> Any:
    """Map unhashable argument shapes onto hashable keys, tagged with
    their container type so ``[160]`` and ``(160,)`` never collide."""
    if isinstance(value, dict):
        return ("dict",
                tuple(sorted((k, _freeze(v)) for k, v in value.items())))
    if isinstance(value, list):
        return ("list", tuple(_freeze(v) for v in value))
    if isinstance(value, tuple):
        return ("tuple", tuple(_freeze(v) for v in value))
    hash(value)  # raise TypeError early, with the offending value visible
    return value


def shared_instance(cls: Callable[..., T], *args: Any, **kwargs: Any) -> T:
    """The canonical ``cls(*args, **kwargs)`` of this process; keys
    compare by equality."""
    key = (cls, _freeze(args), _freeze(tuple(sorted(kwargs.items()))))
    with _lock:
        inst = _cache.get(key)
    if inst is not None:
        return inst
    # constructed outside the lock: a constructor that itself calls
    # shared_instance must not deadlock; of two racing constructions of
    # one key the first stored stays canonical
    inst = cls(*args, **kwargs)
    with _lock:
        return _cache.setdefault(key, inst)


def shared_instance_count() -> int:
    """Number of distinct shared instances held."""
    with _lock:
        return len(_cache)


def clear_shared_instances() -> None:
    """Drop the canonical-instance table."""
    with _lock:
        _cache.clear()
