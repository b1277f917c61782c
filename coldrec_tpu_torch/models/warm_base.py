"""Shared trainer of the warm CF backbones (the port's copy of the
single-device path of ``coldrec_tpu/models/warm_base.py``).

The reference's warm backbones share one loop: epochs over
``next_batch_pairwise``, BPR(+extras) loss, Adam, per-epoch
``fast_evaluation('all')``, an early-stop break, the best tables to the
embedding bus. The cold-start models (``cold_base.py``) share it too.
Subclasses set ``self.model``, an ``nn.Module``, and implement
``loss(batch)`` and, unless the module's ``forward_tables()`` gives them,
``forward_tables()``; ``epoch_hook(epoch)`` runs at the start of every
epoch (NCL's e-step), and the graph backbones take their propagation
operator from ``build_graph()``; everything else lives here once.

The eval tables are recomputed after every epoch (``refresh_tables``: the
module in eval mode under ``no_grad``, then back in training mode) as new
tensors, never aliases of the parameters that Adam updates in place. A
model with BatchNorm keeps its running statistics as module buffers, which
every training-mode call updates (twice a step where the loss calls a
tower twice). Per-step randomness comes from ``self.generator``, a
``torch.Generator`` on the trainer's device seeded from ``--seed``.

Adam is ``torch.optim.Adam`` on dense gradients, the same update as the
JAX package's optax Adam (``tests/test_optimizers.py`` pins the two). Each
batch is built on the host, copied through pinned memory with
``non_blocking=True`` and stepped without a synchronisation; the loss is
read back every 50 batches for the print and once per epoch for the record.
Each epoch's time is split into host batch building, upload, the step (host
enqueue and, on the card, device time from CUDA events), the refresh of the
eval tables (``refresh_s``) and validation, kept in ``epoch_stats`` and sent
to the event log.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ..data.sampler import pairwise_batches
from ..ops.spmm import make_sym_spmm
from ..runtime.checkpoints import (
    load_train_state, save_embeddings, save_train_state,
)
from ..runtime.eval import exact_scores
from ..runtime.trainer import BaseColdStartTrainer


class OptimizerGroups:
    """Several torch optimizers stepped as one, each over its own
    parameters (optax's ``multi_transform``: e.g. VBPR's Adagrad on the
    tables and Adam on the content projection)."""

    def __init__(self, *optimizers: torch.optim.Optimizer):
        self.optimizers = optimizers

    def zero_grad(self, set_to_none: bool = True):
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=set_to_none)

    def step(self):
        for opt in self.optimizers:
            opt.step()

    def state_dict(self) -> list:
        return [opt.state_dict() for opt in self.optimizers]

    def load_state_dict(self, states: list):
        for opt, state in zip(self.optimizers, states):
            opt.load_state_dict(state)


class WarmBackboneTrainer(BaseColdStartTrainer):
    """Subclass contract: set ``self.model`` (an ``nn.Module``), implement
    ``loss(batch) -> scalar tensor`` and, where the module has none,
    ``forward_tables()``, then call ``setup_optimizer()``."""

    model: torch.nn.Module

    def setup_optimizer(self, param_groups=None, optimizer=None):
        """Adam over ``param_groups`` (torch's parameter groups, each with
        its own ``weight_decay``: the gradient plus decay times the weight,
        as optax's ``add_decayed_weights`` before Adam) or over every
        parameter of the model that takes a gradient; or ``optimizer``
        (e.g. an :class:`OptimizerGroups`)."""
        if str(getattr(self.args, "mesh", "") or ""):
            raise NotImplementedError(
                "--mesh: the port trains on one device; mesh training comes "
                "with ROADMAP.md Queue 1, item 7")
        if int(getattr(self.args, "fused_steps", 0) or 0) > 1:
            raise NotImplementedError(
                "--fused_steps > 1 is not in the port (ROADMAP.md Queue 1, "
                "item 8)")
        if optimizer is None:
            optimizer = torch.optim.Adam(
                [p for p in self.model.parameters() if p.requires_grad]
                if param_groups is None else param_groups, lr=self.lr)
        self.optimizer = optimizer
        self.refresh_tables()
        self.save()
        self.epoch_stats: List[Dict] = []

    def refresh_tables(self):
        """Recompute the eval tables from the current weights: new tensors,
        with the module in eval mode (running BatchNorm statistics)."""
        self.model.eval()
        with torch.no_grad():
            ue, ie = self.forward_tables()
            self.user_emb, self.item_emb = ue.clone(), ie.clone()
        self.model.train()

    def init_module(self, cls, init_params=None, init_state=None, **kw):
        """``cls(**kw, device=...)``, seeded from ``--seed``, or the module
        holding the JAX package's ``params`` / ``net_state`` (numpy)."""
        module = cls(**kw, seed=self.seed, device=self.device)
        if init_params is not None:
            module.load_jax(init_params, init_state)
        return module

    def build_graph(self):
        """The normalized-adjacency SpMM operator of the graph backbones:
        the ELL + COO layout with the symmetric custom backward, on the
        trainer's device (the single-device path of the JAX package's
        ``build_graph``; ``--mesh`` is refused by ``setup_optimizer``)."""
        return make_sym_spmm(self.data.norm_adj, device=self.device)

    # ------------------------------------------------------------- contract
    def forward_tables(self):
        """The (user, item) eval tables of the current weights."""
        return self.model.forward_tables()

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def epoch_hook(self, epoch: int):
        """Called at the start of every epoch (e.g. NCL's e-step)."""

    def extra_saved_tensors(self) -> Dict[str, torch.Tensor]:
        """Tensors written to the bus beside the best tables."""
        return {}

    def batches(self):
        """Per-epoch batch iterator; override for model-specific samplers."""
        return pairwise_batches(self.data, self.batch_size, self.host_rng)

    # ----------------------------------------------------------------- step
    def upload(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The host batch on the trainer's device (through pinned memory and
        an asynchronous copy on the card)."""
        if self.device.type != "cuda":
            return {k: torch.from_numpy(v) for k, v in batch.items()}
        return {k: torch.from_numpy(v).pin_memory().to(
            self.device, non_blocking=True) for k, v in batch.items()}

    def train_step(self, batch: Dict[str, torch.Tensor],
                   **kw) -> torch.Tensor:
        """One Adam step on a device batch; returns the loss (no sync).
        ``kw`` goes to ``loss`` (e.g. DropoutNet's injected masks)."""
        loss = self.loss(batch, **kw)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _train_epoch(self, epoch: int) -> Dict:
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t_epoch = time.perf_counter()
        secs = dict.fromkeys(("host_s", "upload_s", "step_host_s"), 0.0)
        losses, marks = [], []
        batches = iter(self.batches())
        n = 0
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            t1 = time.perf_counter()
            secs["host_s"] += t1 - t0
            if batch is None:
                break
            dev_batch = self.upload(batch)
            t2 = time.perf_counter()
            secs["upload_s"] += t2 - t1
            if cuda:
                marks.append((torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True)))
                marks[-1][0].record()
            loss = self.train_step(dev_batch)
            if cuda:
                marks[-1][1].record()
            secs["step_host_s"] += time.perf_counter() - t2
            losses.append(loss)
            if n % 50 == 0:
                print(
                    f"training: {epoch + 1} batch {n} "
                    f"batch_loss: {float(loss):.5f}"
                )
            n += 1
        losses = torch.stack(losses).tolist() if losses else []
        stats = {
            "epoch": epoch + 1,
            "batches": n,
            **secs,
            # on the CPU the step runs as it is enqueued
            "step_device_s": (sum(a.elapsed_time(b) for a, b in marks) / 1e3
                              if cuda else secs["step_host_s"]),
            "train_s": time.perf_counter() - t_epoch,
            "losses": losses,
        }
        return stats

    # ------------------------------------------------------------- resume
    def _ckpt_path(self) -> str:
        return str(getattr(self.args, "state_ckpt", "") or "")

    def _save_train_state(self, epoch: int):
        cuda = self.device.type == "cuda"
        save_train_state(self._ckpt_path(), {
            "epoch": epoch,
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "host_rng_state": self.host_rng.bit_generator.state,
            "torch_rng_state": torch.get_rng_state(),
            "cuda_rng_state": (torch.cuda.get_rng_state(self.device)
                               if cuda else None),
            "generator_state": self.generator.get_state(),
            "best_user_emb": self.best_user_emb,
            "best_item_emb": self.best_item_emb,
            "best_performance": self.best_performance,
            "early_stop_patience": getattr(self, "early_stop_patience", None),
        })

    def _try_resume(self) -> int:
        """Restore mid-training state; returns the epoch to resume from."""
        path = self._ckpt_path()
        if not path:
            return 0
        state = load_train_state(path)
        if state is None:
            return 0
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.host_rng.bit_generator.state = state["host_rng_state"]
        torch.set_rng_state(state["torch_rng_state"])
        if self.device.type == "cuda" and state["cuda_rng_state"] is not None:
            torch.cuda.set_rng_state(state["cuda_rng_state"], self.device)
        self.generator.set_state(state["generator_state"])
        self.best_user_emb = state["best_user_emb"].to(self.device)
        self.best_item_emb = state["best_item_emb"].to(self.device)
        self.best_performance = state["best_performance"]
        if state["early_stop_patience"] is not None and self.early_stop_flag:
            self.early_stop_patience = state["early_stop_patience"]
        self.refresh_tables()
        print(f"resumed training state from {path} at epoch {state['epoch'] + 1}")
        return int(state["epoch"]) + 1

    # ----------------------------------------------------------------- loop
    def train(self):
        self.timer(start=True)
        start_epoch = self._try_resume()
        epoch = start_epoch - 1
        for epoch in range(start_epoch, self.max_epoch):
            self.epoch_hook(epoch)
            stats = self._train_epoch(epoch)
            t = time.perf_counter()
            self.refresh_tables()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            stats["refresh_s"] = time.perf_counter() - t
            stop = False
            if epoch % self.eval_every == 0:
                t = time.perf_counter()
                self.fast_evaluation(epoch, valid_type="all")
                stats["validation_s"] = time.perf_counter() - t
                stop = self.should_stop()
            self.epoch_stats.append(stats)
            self.events.emit("epoch", **stats)
            if stop:
                break
            if self._ckpt_path():
                self._save_train_state(epoch)
        self.epochs_ran = (epoch + 1) if self.max_epoch > 0 else 0
        self.timer(start=False)
        self.user_emb, self.item_emb = self.best_user_emb, self.best_item_emb
        if self.args.save_emb:
            save_embeddings(
                self.args.emb_dir,
                self.dataset_name,
                self.args.cold_object,
                self.model_name,
                {"user_emb": self.user_emb, "item_emb": self.item_emb,
                 **self.extra_saved_tensors()},
                fmt=getattr(self.args, "save_emb_format", "npz"),
            )

    def save(self):
        # the eval tables are fresh tensors (refresh_tables), never updated
        self.best_user_emb = self.user_emb
        self.best_item_emb = self.item_emb

    def batch_scores(self, user_ids: np.ndarray) -> torch.Tensor:
        idx = torch.as_tensor(np.asarray(user_ids), device=self.device).long()
        return exact_scores(self.user_emb[idx], self.item_emb)
