"""String registries for cores and readouts, mirroring the reference's
``@register`` decorators (src/v1t/models/core/core.py:8-16,
src/v1t/models/readout/readout.py:10-18)."""

from __future__ import annotations

import typing as t

_CORES: t.Dict[str, type] = {}
_READOUTS: t.Dict[str, type] = {}


def register_core(name: str):
    def wrap(cls):
        _CORES[name] = cls
        return cls

    return wrap


def register_readout(name: str):
    def wrap(cls):
        _READOUTS[name] = cls
        return cls

    return wrap


def get_core(name: str) -> type:
    if name not in _CORES:
        raise NotImplementedError(
            f"core {name!r} not ported; available: {sorted(_CORES)}"
        )
    return _CORES[name]


def get_readout(name: str) -> type:
    if name not in _READOUTS:
        raise NotImplementedError(
            f"readout {name!r} not ported; available: {sorted(_READOUTS)}"
        )
    return _READOUTS[name]
