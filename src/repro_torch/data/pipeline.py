"""Deterministic, restartable data pipeline, the reference's
``data/pipeline.py`` in PyTorch.

The stream is a stateless function of (seed, step) so a restarted run
resumes bit-exact mid-epoch without replaying data.  Batches are built
with numpy exactly as the reference builds them (the same generator, the
same draws), so the two packages see the same tokens.  The last hop
places a batch on a ``DeviceMesh`` (:func:`shard_batch`: the batch dim
over the data axes, each rank cutting its rows from the global batch it
built) or copies it to one device (:func:`to_device`, pinned and
non-blocking on a card).

``SyntheticLMStream`` generates structured pseudo-text (Zipfian unigrams +
a deterministic bigram mixing rule) rather than uniform noise so models can
actually learn, while needing no files.  A binary-tokens file reader with
the same interface covers real corpora.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 1234
    memory_tokens: int = 0     # stub-frontend embeddings (vlm/audio)
    d_model: int = 0
    prefetch: int = 2


class SyntheticLMStream:
    """Deterministic synthetic LM token stream with learnable structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed Zipfian unigram table + deterministic "grammar" permutation
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._perm = rng.permutation(cfg.vocab)

    def global_batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, t = cfg.global_batch, cfg.seq_len
        base = rng.choice(cfg.vocab, size=(b, t + 1), p=self._probs)
        # bigram structure: with p=.5 the next token is a fixed function of
        # the previous one -- gives the model something to learn
        follow = self._perm[base[:, :-1]]
        coin = rng.random((b, t)) < 0.5
        toks = base[:, 1:].copy()
        toks[coin] = follow[coin]
        tokens = np.concatenate([base[:, :1], toks], axis=1).astype(np.int32)
        batch = {"tokens": tokens[:, :-1],
                 "labels": tokens[:, 1:].astype(np.int32)}
        if cfg.memory_tokens:
            batch["memory"] = rng.standard_normal(
                (b, cfg.memory_tokens, cfg.d_model)).astype(np.float32)
        return batch


class TokenFileStream:
    """Pre-tokenized flat binary (int32) corpus reader, deterministic by
    (seed, step): each batch gathers global_batch random windows."""

    def __init__(self, cfg: DataConfig, path: str):
        self.cfg = cfg
        self._data = np.memmap(path, dtype=np.int32, mode="r")
        if len(self._data) < cfg.seq_len + 1:
            raise ValueError("corpus shorter than one sequence")

    def global_batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        starts = rng.integers(0, len(self._data) - cfg.seq_len - 1,
                              size=cfg.global_batch)
        seqs = np.stack([self._data[s: s + cfg.seq_len + 1] for s in starts])
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32)}


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device`` (from pinned host memory,
    without blocking, on a card)."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def put(arr):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if cuda:
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return {k: put(v) for k, v in batch.items()}


def shard_batch(batch: dict, mesh) -> dict:
    """Place a global numpy batch onto the mesh (batch dim over data axes;
    replicated where they do not divide it)."""
    from repro_torch.models import sharding as sh

    local = to_device(batch, mesh.device_type)
    return {k: sh.place(v, sh._fit((sh.dp_axes(mesh),) + (None,) *
                                   (v.ndim - 1), tuple(v.shape), mesh), mesh)
            for k, v in local.items()}


def make_batch_iterator(stream, mesh, start_step: int = 0,
                        prefetch: int = 2) -> Iterator[dict]:
    """Background-threaded, prefetching, restartable iterator of batches
    placed on ``mesh`` (a ``DeviceMesh``: :func:`shard_batch`) or copied
    to a device (:func:`to_device`); closing it stops its producer
    thread."""
    from repro_torch.launch.mesh import is_mesh

    put = shard_batch if is_mesh(mesh) else to_device
    q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()

    def producer():
        step = start_step
        pending = None
        while not stop.is_set():
            if pending is None:
                # build the batch once; a full queue must not re-build it
                # on every put retry
                pending = stream.global_batch_at(step)
                step += 1
            try:
                q.put(pending, timeout=0.5)
                pending = None
            except queue.Full:
                continue

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    try:
        while True:
            yield put(q.get(), mesh)
    finally:
        stop.set()
        th.join(timeout=2.0)
