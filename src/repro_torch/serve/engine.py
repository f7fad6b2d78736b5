"""Batched serving engine: prefill + decode loop with KV/state caches, the
reference's ``serve/engine.py`` in PyTorch.

Requests are padded-left into a fixed batch (pad id 0, unmasked, as in the
reference).  Greedy or temperature sampling; per-row EOS tracking; ring
caches (SWA) and O(1) SSM states come through the model factory's cache
machinery.  On the card prefill attention and every Mamba scan launch the
hand-written kernels.  Given a ``DeviceMesh``, the parameters, prompts and
caches are DTensors placed by the sharding rules (the prefill and decode
steps are ``build_cell``'s); given a device, it serves there without
DTensors.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import is_mesh
from repro_torch.launch.steps import on_mesh
from repro_torch.models import sharding as sh
from repro_torch.models.model import build_model


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 => greedy
    eos_id: int = -1               # -1 => never stops early
    seed: int = 0


class ServeEngine:
    def __init__(self, cfg: ArchConfig, mesh="cuda", params=None,
                 seed: int = 0):
        """An engine on ``mesh``: a ``DeviceMesh``, or a device (the card
        unless the caller asks for the CPU); ``params`` (a ``ParamTree``,
        e.g. from ``convert.lm_params``, placed on the mesh as a new tree)
        or the model's own init from ``seed``."""
        self.cfg = cfg
        self.mesh = mesh if is_mesh(mesh) else None
        self.device = torch.device(mesh.device_type if self.mesh else mesh)
        self.model = build_model(cfg, shard_act=sh.make_shard_act(self.mesh))
        params = params if params is not None else \
            self.model.init(seed, self.device)
        if self.mesh is not None:
            params = sh.distribute(params, sh.param_shardings(
                cfg, params, self.mesh), self.mesh)
        self.params = params

    def _prefill(self, params, batch):
        return on_mesh(self.model.prefill, self.mesh)(params, batch)

    def _decode(self, params, caches, tokens):
        return on_mesh(self.model.decode, self.mesh)(params, caches, tokens)

    def _place(self, tree, specs):
        return tree if self.mesh is None else \
            sh.distribute(tree, specs, self.mesh)

    def _tokens(self, x: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(x, device=self.device)
        return self._place(t, sh.batch_rule("tokens", tuple(t.shape),
                                            self.mesh)) if self.mesh else t

    def _pad_batch(self, prompts: list[list[int]]) -> np.ndarray:
        width = max(len(p) for p in prompts)
        out = np.zeros((len(prompts), width), np.int64)
        for i, p in enumerate(prompts):
            out[i, width - len(p):] = p       # left padding
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts: list[list[int]],
                 gen: GenerationConfig = GenerationConfig(),
                 memory: np.ndarray | None = None) -> dict:
        t0 = time.perf_counter()
        tokens = self._tokens(self._pad_batch(prompts))
        b, t = tokens.shape
        caches = self.model.init_cache(b, t + gen.max_new_tokens, self.device)
        if self.mesh is not None:
            caches = self._place(caches, sh.cache_shardings(
                self.cfg, caches, self.mesh))
        batch = {"tokens": tokens, "caches": caches}
        if memory is not None:
            batch["memory"] = torch.as_tensor(memory, device=self.device)
        elif self.cfg.n_memory:
            batch["memory"] = torch.zeros(
                (b, self.cfg.n_memory, self.cfg.d_model), dtype=torch.bfloat16,
                device=self.device)
        if self.mesh is not None and "memory" in batch:
            batch["memory"] = self._place(batch["memory"], sh.batch_rule(
                "memory", tuple(batch["memory"].shape), self.mesh))

        logits, caches = self._prefill(self.params, batch)
        self._sync()
        t_prefill = time.perf_counter() - t0

        rng = torch.Generator(device=self.device)
        rng.manual_seed(gen.seed)
        out = np.zeros((b, gen.max_new_tokens), np.int64)
        done = np.zeros((b,), bool)
        last = sh.gather(logits[:, -1])
        t1 = time.perf_counter()
        for i in range(gen.max_new_tokens):
            if gen.temperature > 0:
                probs = torch.softmax(last / gen.temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=rng)[:, 0]
            else:
                nxt = torch.argmax(last, dim=-1)
            nxt = nxt.cpu().numpy()
            out[:, i] = np.where(done, gen.eos_id, nxt)
            done |= nxt == gen.eos_id
            if done.all():
                out = out[:, : i + 1]
                break
            logits, caches = self._decode(self.params, caches,
                                          self._tokens(nxt[:, None]))
            last = sh.gather(logits[:, -1])
        self._sync()
        t_decode = time.perf_counter() - t1
        n_new = out.shape[1]
        return {
            "tokens": out,
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tokens_per_s": b * n_new / max(t_decode, 1e-9),
        }
