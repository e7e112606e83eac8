"""Immutable "data cards": what model construction needs to know about the
dataset (shapes, per-mouse neuron counts, coordinates and response
statistics), as plain host-side numpy.

A numpy-only copy of the JAX package's ``data/cards.py`` plus its
``micro_batching`` helper (``data/loaders.py``); the loader threads are not
part of the port yet.
"""

from __future__ import annotations

import dataclasses
import typing as t

import numpy as np


@dataclasses.dataclass(frozen=True)
class NeuronCard:
    """Per-mouse facts the model needs (neuron count, anatomical coordinates
    for the grid predictor, response statistics for bias init)."""

    mouse_id: str
    num_neurons: int
    coordinates: np.ndarray  # (N, 3) anatomical (x, y, z)
    response_mean: np.ndarray  # (N,)
    response_std: np.ndarray  # (N,)
    neuron_ids: t.Optional[np.ndarray] = None  # (N,)

    def __post_init__(self):
        assert self.coordinates.shape[0] == self.num_neurons


@dataclasses.dataclass(frozen=True)
class DataCard:
    """Run-level facts derived from the dataset."""

    ds_name: str  # "sensorium" | "franke2022"
    input_shape: t.Tuple[int, int, int]  # raw image shape (C, H, W)
    mouse_ids: t.Tuple[str, ...]
    neuron_cards: t.Dict[str, NeuronCard]
    ds_sizes: t.Dict[str, int]  # mouse_id -> len(train set)

    @property
    def output_shapes(self) -> t.Dict[str, t.Tuple[int]]:
        return {m: (c.num_neurons,) for m, c in self.neuron_cards.items()}


def synthetic_data_card(
    mouse_ids: t.Sequence[str] = ("A", "B"),
    num_neurons: t.Union[int, t.Sequence[int]] = 100,
    input_shape: t.Tuple[int, int, int] = (1, 36, 64),
    ds_name: str = "sensorium",
    ds_size: int = 256,
    seed: int = 0,
) -> DataCard:
    """A small synthetic DataCard for tests and dry runs."""
    rng = np.random.default_rng(seed)
    if isinstance(num_neurons, int):
        num_neurons = [num_neurons] * len(mouse_ids)
    cards = {}
    for mouse_id, n in zip(mouse_ids, num_neurons):
        cards[mouse_id] = NeuronCard(
            mouse_id=mouse_id,
            num_neurons=n,
            coordinates=rng.normal(size=(n, 3)).astype(np.float32) * 100,
            response_mean=rng.gamma(2.0, 1.0, size=n).astype(np.float32),
            response_std=rng.gamma(2.0, 1.0, size=n).astype(np.float32) + 0.1,
            neuron_ids=np.arange(n, dtype=np.int32),
        )
    return DataCard(
        ds_name=ds_name,
        input_shape=tuple(input_shape),
        mouse_ids=tuple(mouse_ids),
        neuron_cards=cards,
        ds_sizes={m: ds_size for m in mouse_ids},
    )


def micro_batching(batch: t.Dict[str, np.ndarray], batch_size: int):
    """Slice a batch dict into micro-batches (reference data.py:106-110)."""
    indexes = np.arange(0, len(batch["image"]), step=batch_size, dtype=int)
    for i in indexes:
        yield {
            k: v[i : i + batch_size] if isinstance(v, np.ndarray) else v
            for k, v in batch.items()
        }
