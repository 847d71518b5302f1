"""Deterministic synthetic data pipeline with checkpointable iterator state
(the port's copy of ``repro.data.pipeline``: the same numpy Philox stream,
so every batch is byte for byte ``repro``'s).

Real clusters stream tokenised documents; here the stream is a seeded
counter-mode generator (Philox via numpy) so that (a) every batch is a pure
function of (seed, step) — a crashed-and-restarted trainer reproduces the
exact token stream, which the fault-tolerance tests assert bitwise; (b) no
host state needs to survive a preemption except the integer step.

The "document" stream packs variable-length documents into fixed-length
rows with EOS separators and a loss mask — the realistic shape of an LM
pipeline — and the modality stubs (patch/frame embeddings) are generated
the same counter-mode way. :func:`input_specs` is the dry run's shape
contract: meta tensors for every model input of an (arch, shape) cell.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.config import ModelConfig, ShapeConfig


@dataclass
class PipelineState:
    seed: int
    step: int = 0

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticLMData:
    """Packed-document LM batches, derived purely from (seed, step)."""

    def __init__(
        self,
        cfg: ModelConfig,
        batch: int,
        seq_len: int,
        seed: int = 0,
        mean_doc_len: int = 512,
        eos: int = 0,
    ):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.state = PipelineState(seed=seed)
        self.mean_doc_len = mean_doc_len
        self.eos = eos

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=self.state.seed, counter=step)
        )

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of step — the checkpointable contract."""
        cfg = self.cfg
        rng = self._rng(step)
        b, s = self.batch, self.seq_len
        tokens = np.empty((b, s), np.int32)
        mask = np.ones((b, s), np.float32)
        # pack documents with EOS boundaries
        for row in range(b):
            pos = 0
            while pos < s:
                dl = int(rng.geometric(1.0 / self.mean_doc_len))
                dl = max(1, min(max(dl, 4), s - pos))
                # mildly-structured tokens (arithmetic progressions mod vocab)
                start = rng.integers(1, cfg.vocab_size)
                stride = rng.integers(1, 7)
                tokens[row, pos : pos + dl] = (
                    start + stride * np.arange(dl)
                ) % cfg.vocab_size
                if pos + dl < s:
                    tokens[row, pos + dl - 1] = self.eos
                pos += dl
        labels = np.roll(tokens, -1, axis=1)
        mask[:, -1] = 0.0  # no target for the last position
        out = {"tokens": tokens, "labels": labels.astype(np.int32), "loss_mask": mask}
        if cfg.family == "vlm":
            out["patch_embeds"] = rng.standard_normal(
                (b, cfg.n_patches, cfg.d_model), np.float32
            ).astype(np.float32)
        if cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (b, cfg.enc_frames, cfg.d_model), np.float32
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            batch = self.batch_at(self.state.step)
            self.state.step += 1
            yield batch

    # -- checkpointing ------------------------------------------------------
    def state_dict(self):
        return self.state.to_dict()

    def load_state_dict(self, d):
        self.state = PipelineState.from_dict(d)



def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of an (arch, shape) cell,
    ``repro``'s shapes and dtypes (int32 tokens, f32 masks and embeddings):
    the dry run's contract, no storage allocated."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    f32, i32 = torch.float32, torch.int32
    if shape.kind == "decode":
        # one new token against a seq_len-deep cache
        return {"tokens": meta((b, 1), i32), "cur_pos": meta((b,), i32)}
    specs = {"tokens": meta((b, s), i32)}
    if shape.kind == "train":
        specs["labels"] = meta((b, s), i32)
        specs["loss_mask"] = meta((b, s), f32)
    if cfg.family == "vlm":
        specs["patch_embeds"] = meta((b, cfg.n_patches, cfg.d_model), f32)
    if cfg.family == "encdec":
        specs["frames"] = meta((b, cfg.enc_frames, cfg.d_model), f32)
    return specs
