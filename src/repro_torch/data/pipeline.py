"""Deterministic, checkpointable data pipeline, the port's counterpart of
``repro.data.pipeline`` (a copy that makes the same batches bit for bit).

Synthetic LM token streams (structured enough for loss to fall: Zipf
unigrams + copy motifs) drawn per (seed, step) with numpy on the host:
resuming from a checkpoint cursor reproduces the exact batch sequence.
Background prefetch keeps the host ahead of the device step.  Batches are
numpy arrays; the trainer moves them to the step's device.

Two repairs of the reference's prefetch, which make no batch differ: the
worker keeps a batch that met a full queue and offers it again (the
reference drew the next one, so a slow consumer skipped batches), and
``next_step`` is the step of the next batch ``get`` will hand out, which
is what a checkpoint must record (the prefetching cursor runs ahead).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs import ModelConfig, ShapeConfig


@dataclasses.dataclass
class Cursor:
    step: int = 0
    seed: int = 0

    def to_dict(self):
        return {"step": self.step, "seed": self.seed}

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


class DataPipeline:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *,
                 seed: int = 0, prefetch: int = 2,
                 cursor: Optional[Cursor] = None):
        self.cfg = cfg
        self.shape = shape
        self.cursor = cursor or Cursor(seed=seed)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.next_step = self.cursor.step

    # ---------------- deterministic batch synthesis ----------------
    def _batch_for(self, step: int) -> Dict[str, np.ndarray]:
        cfg, shape = self.cfg, self.shape
        rng = np.random.default_rng((self.cursor.seed, step))
        B, S = shape.global_batch, shape.seq_len
        V = cfg.vocab_size
        # zipf unigrams + embedded copy motifs (gives a learnable signal)
        ranks = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
        toks = np.minimum(ranks, V - 1).astype(np.int32)
        motif_len = 16
        n_motifs = S // 256
        for b in range(B):
            motif = rng.integers(0, min(V, 1024), motif_len)
            for _ in range(n_motifs):
                at = int(rng.integers(0, S + 1 - motif_len))
                toks[b, at:at + motif_len] = motif
        batch: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if cfg.family == "vlm":
            nv = cfg.n_vision_tokens
            batch["tokens"] = batch["tokens"][:, :S - nv]
            batch["targets"] = batch["targets"][:, :S - nv]
            batch["vision_embeds"] = rng.normal(
                0, 0.1, (B, nv, cfg.d_model)).astype(np.float32)
            t = np.arange(S, dtype=np.int32)
            batch["positions3"] = np.broadcast_to(t, (3, B, S)).copy()
        if cfg.is_encdec:
            batch["audio_embeds"] = rng.normal(
                0, 0.1, (B, cfg.n_audio_frames, cfg.d_model)).astype(
                    np.float32)
        return batch

    # ---------------- iteration + prefetch ----------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self._batch_for(self.cursor.step)
        self.cursor.step += 1
        return b

    def start_prefetch(self):
        def worker():
            item = None
            while not self._stop.is_set():
                if item is None:
                    item = (self.cursor.step, self.__next__())
                try:
                    self._q.put(item, timeout=0.5)
                    item = None
                except queue.Full:
                    continue
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def get(self) -> Dict[str, np.ndarray]:
        if self._thread is None:
            step, b = self.cursor.step, self.__next__()
        else:
            step, b = self._q.get()
        self.next_step = step + 1
        return b

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
