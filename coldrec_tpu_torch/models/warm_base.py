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

``--fused_steps K`` (the JAX package's ``lax.scan`` over K stacked batches)
stacks K host batches of one shape, uploads each key's stack in one
transfer and runs the K steps on its slices with no host sync in between;
the group's losses are read at most once (where a print falls in it). The
steps, their order and every draw are the per-batch loop's. A group's
stacking counts as upload, its CUDA events span its K steps. Only the
default Adam over every parameter qualifies (``fused_ok``, JAX's
``_fused_ok``); a tail shorter than K, and a batch whose shapes differ
from its group's, run per batch.

``--mesh DxM`` and process groups (``_setup_mesh``, the counterpart of the
JAX package's ``_setup_mesh`` / ``build_graph`` / ``_place_batch`` /
``_local_tables``): one rank per mesh position (``parallel/mesh.py``). A
table whose height is ``user_num`` or ``item_num`` and divides M keeps only
this rank's row block (``sharded``); the batch splits into contiguous
blocks over the data axis; the loss's additive parts are summed over the
data group (``reduce_parts``) and, after the backward, every gradient too,
so each rank's Adam steps its own rows with the global batch's gradient.
Every ``MaskedBatchNorm1d`` of the model takes the data group, so its
statistics are the global batch's (``_sync_batchnorm``), and a draw over
the batch is made for the global batch on every rank, each keeping its
block (``data_block``; a whole plane ``plane_rand``). A loss whose terms
run over the global batch (an InfoNCE's columns) takes the batch's
``global_keys`` whole as ``<key>_all`` (``global_rows``). The eval tables
are gathered whole on every rank. A process group with no ``--mesh`` is
data-parallel over every rank, as in the JAX package. Every trainer
states its ``mesh_support``: ``"sharded"`` models take a mesh, those whose
JAX trainer never sets one up (``"one_device"``: ALDI, FSGNN, M2VAE, MTPR,
VBPR, AMR, USIM) ignore it. Under a
group, rank 0 alone writes the bus and the train state; sharded tables and
their Adam moments are gathered before the write and sharded again on
resume.

``--debug_nans`` (JAX's ``jax_debug_nans``; ``main.run`` turns on autograd's
anomaly mode, which checks every backward for NaN): each step's loss must
be finite and so must the eval tables at every refresh, else
``FloatingPointError`` names the epoch and batch. Off, nothing is checked
and nothing syncs.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List

import numpy as np
import torch

from ..data.sampler import pairwise_batches
from ..ops.spmm import make_sym_spmm
from ..parallel.distributed import (
    all_reduce, barrier, host_block, is_multiprocess, localize,
    process_count, process_index,
)
from ..parallel.mesh import make_mesh, parse_mesh, shards_rows
from ..parallel.ops import (
    AllReduceIdentity, CopyToGroup, MeshGraph, gather_rows, shard_rows,
    sharded_lookup,
)
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
    # --fused_steps replays ``train_step`` on stacked batches; a model whose
    # JAX counterpart keeps network state (BatchNorm) or builds its own step
    # sets this False and keeps the per-batch loop, as there
    fused_ok = True
    current_epoch = None  # the epoch being trained, for --debug_nans
    # stated by every trainer: "sharded", the loss as partial sums and the
    # tables through parallel.ops, so --mesh and process groups run;
    # "one_device", --mesh ignored, as the JAX trainer never sets up its mesh
    mesh_support: str
    # batch columns the loss also takes whole under a data axis, as
    # ``<key>_all`` (the global batch's ids of an InfoNCE's columns)
    global_keys = ()
    mesh = None
    sharded = frozenset()  # names of the row-sharded parameters
    _mesh_done = False

    def setup_optimizer(self, param_groups=None, optimizer=None):
        """Adam over ``param_groups`` (torch's parameter groups, each with
        its own ``weight_decay``: the gradient plus decay times the weight,
        as optax's ``add_decayed_weights`` before Adam) or over every
        parameter of the model that takes a gradient; or ``optimizer``
        (e.g. an :class:`OptimizerGroups`)."""
        if self._setup_mesh() is not None:
            self._shard_tables()
            self._sync_batchnorm()
        self._fused_ok = (self.fused_ok and param_groups is None
                          and optimizer is None)
        if optimizer is None:
            optimizer = torch.optim.Adam(
                [p for p in self.model.parameters() if p.requires_grad]
                if param_groups is None else param_groups, lr=self.lr)
        self.optimizer = optimizer
        self.refresh_tables()
        self.save()
        self.epoch_stats: List[Dict] = []

    # ------------------------------------------------------------- mesh
    def _setup_mesh(self):
        """The mesh of ``--mesh DxM`` (a process group with none: D = every
        rank, M = 1), or None for the single-device path; built once (the
        graph backbones need it before their tables exist)."""
        if self._mesh_done:
            return self.mesh
        self._mesh_done = True
        spec = str(getattr(self.args, "mesh", "") or "")
        multi = is_multiprocess()
        if (not spec and not multi) or self.mesh_support == "one_device":
            return None
        n_data, n_model = parse_mesh(spec) if spec else (process_count(), 1)
        if n_data * n_model == 1 and not multi:
            return None
        self.mesh = make_mesh(n_data, n_model)
        return self.mesh

    def _shard_tables(self):
        """Keep this rank's row block of every table the rule shards. A
        table is a parameter of the model itself (``user_emb``), read
        through ``lookup`` / ``full_table``; a weight of a submodule (a
        Linear of DropoutNet's towers, (out, in) here where the JAX
        package's is (in, out)) is used whole by its module, so it stays
        replicated whatever its height."""
        rows = {self.data.user_num, self.data.item_num}
        names = []
        for name, p in self.model.named_parameters(recurse=False):
            if shards_rows(tuple(p.shape), rows, self.mesh.n_model):
                p.data = shard_rows(self.mesh, p.data).clone()
                names.append(name)
        self.sharded = frozenset(names)

    def _sync_batchnorm(self):
        """Every ``MaskedBatchNorm1d`` of the model computes its statistics
        over the data group (the global batch)."""
        from .common import MaskedBatchNorm1d

        for module in self.model.modules():
            if isinstance(module, MaskedBatchNorm1d):
                module.group = self.mesh.data_group

    @property
    def n_data(self) -> int:
        """Ranks over which the batch is split (1 without a data axis)."""
        return 1 if self.mesh is None else self.mesh.n_data

    def data_block(self, x):
        """This rank's contiguous block of ``x``, a tensor or array over the
        global batch's rows (``x`` itself without a data axis)."""
        if self.n_data == 1:
            return x
        return host_block(x, self.mesh.n_data, self.mesh.data_index)

    def data_offset(self, n_rows: int) -> int:
        """The first row of this rank's :meth:`data_block` of ``n_rows``."""
        if self.n_data == 1:
            return 0
        return self.mesh.data_index * (n_rows // self.mesh.n_data)

    def global_rows(self, batch: Dict[str, torch.Tensor], key: str):
        """The global batch's column ``key`` (``global_keys``): whole on
        every rank of a data axis, the batch's own column without one."""
        return batch.get(f"{key}_all", batch[key])

    def plane_rand(self, shape, dtype=torch.float32, block=None):
        """U(0,1) of the whole ``shape`` from ``self.generator``, drawn
        alike on every rank (the generators share one state), so the stream
        matches one rank's draw for draw; ``block(x)`` keeps this rank's
        part of it (the whole plane without ``block``)."""
        x = torch.rand(shape, generator=self.generator, device=self.device,
                       dtype=dtype)
        return x if block is None else block(x)

    def lookup(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of the model's table ``name`` (the exchange or
        gather lookup where it is row-sharded)."""
        table = getattr(self.model, name)
        if name in self.sharded:
            return sharded_lookup(self.mesh, table, ids)
        return table[ids]

    def full_table(self, name: str, replicated: bool = True) -> torch.Tensor:
        """The whole table ``name`` on this rank. ``replicated=False``: the
        caller uses only its own part of it, so its gradient is summed over
        the model group."""
        table = getattr(self.model, name)
        if name in self.sharded:
            return gather_rows(self.mesh, table, replicated)
        if not replicated and self.mesh is not None \
                and self.mesh.model_group is not None:
            return CopyToGroup.apply(table, self.mesh.model_group)
        return table

    def reduce_parts(self, parts: torch.Tensor) -> torch.Tensor:
        """The loss's additive parts summed over the data group (backward:
        the identity, as every rank goes on to the same loss)."""
        if self.mesh is None or self.mesh.data_group is None:
            return parts
        return AllReduceIdentity.apply(parts, self.mesh.data_group)

    def _place_batch(self, batch: Dict[str, np.ndarray]):
        """This rank's contiguous block of the host batch over the data
        axis (``P(AXIS_DATA)``); the columns of ``global_keys`` also whole,
        as ``<key>_all`` (every rank holds the same host batch)."""
        out = {k: self.data_block(v) for k, v in batch.items()}
        if self.n_data > 1:
            out.update({f"{k}_all": batch[k] for k in self.global_keys})
        return out

    def _reduce_grads(self):
        """Every gradient summed over the data group, in one all-reduce."""
        if self.mesh is None or self.mesh.data_group is None:
            return
        params = [p for p in self.model.parameters() if p.grad is not None]
        flat = all_reduce(torch.cat([p.grad.reshape(-1) for p in params]),
                          self.mesh.data_group)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)

    def refresh_tables(self):
        """Recompute the eval tables from the current weights: new tensors,
        with the module in eval mode (running BatchNorm statistics)."""
        self.model.eval()
        with torch.no_grad():
            ue, ie = self.forward_tables()
            self.user_emb, self.item_emb = ue.clone(), ie.clone()
        self.model.train()
        if self.debug_nans:
            for side, table in (("user", self.user_emb),
                                ("item", self.item_emb)):
                if not bool(torch.isfinite(table).all()):
                    when = ("before training" if self.current_epoch is None
                            else f"after epoch {self.current_epoch + 1}")
                    raise FloatingPointError(
                        f"--debug_nans: non-finite values in the {side} "
                        f"eval table of {self.model_name} {when}")

    @property
    def debug_nans(self) -> bool:
        return bool(getattr(self.args, "debug_nans", False))

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
        trainer's device; under a mesh with a model axis > 1 the
        node-row-sharded :class:`MeshGraph` (the JAX package's
        ``build_graph``)."""
        mesh = self._setup_mesh()
        if mesh is not None and mesh.n_model > 1:
            return MeshGraph(mesh, self.data.norm_adj,
                             self.data.user_num + self.data.item_num,
                             device=self.device)
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
        an asynchronous copy on the card); under a data axis, this rank's
        block of it."""
        batch = self._place_batch(batch)
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
        self._reduce_grads()
        self.optimizer.step()
        return loss.detach()

    def _use_fused(self) -> int:
        """K of ``--fused_steps`` where it applies (K > 1 and ``fused_ok``
        with the default optimizer, on one device and one process), else 0:
        the per-batch loop."""
        if self.mesh is not None or is_multiprocess():
            return 0
        k = int(getattr(self.args, "fused_steps", 0) or 0)
        return k if k > 1 and getattr(self, "_fused_ok", False) else 0

    def _groups(self, k: int, secs: Dict):
        """The epoch's batches in their order: lists of ``k`` batches of one
        shape, every other batch alone (``k`` 0: each alone). Seconds spent
        drawing them go to ``secs["host_s"]``. ``Config.epoch_steps`` > 0
        stops the epoch after that many batches."""
        it = iter(self.batches())
        if self.config.epoch_steps:
            it = itertools.islice(it, self.config.epoch_steps)
        group = []
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            secs["host_s"] += time.perf_counter() - t
            if batch is None:
                break
            if group and _shapes(batch) != _shapes(group[0]):
                yield from ([b] for b in group)
                group = []
            group.append(batch)
            if len(group) >= max(k, 1):
                yield group
                group = []
        yield from ([b] for b in group)

    def upload_group(self, group) -> List[Dict[str, torch.Tensor]]:
        """Batches of one shape stacked on the host, each key's stack
        uploaded in one transfer; returns the device batches (views)."""
        if len(group) == 1:
            return [self.upload(group[0])]
        stacked = self.upload({key: np.stack([b[key] for b in group])
                               for key in group[0]})
        return [{key: v[i] for key, v in stacked.items()}
                for i in range(len(group))]

    def _checked_step(self, batch, epoch: int, n: int) -> torch.Tensor:
        """``train_step``; under ``--debug_nans`` a NaN in its backward
        (anomaly mode's RuntimeError) or a non-finite loss raises
        ``FloatingPointError`` naming the epoch and batch."""
        if not self.debug_nans:
            return self.train_step(batch)
        where = f"epoch {epoch + 1} batch {n}"
        try:
            loss = self.train_step(batch)
        except RuntimeError as e:
            if "returned nan values" not in str(e):
                raise
            raise FloatingPointError(
                f"--debug_nans: NaN in the backward of {where}: {e}") from e
        if not bool(torch.isfinite(loss)):
            raise FloatingPointError(
                f"--debug_nans: loss {float(loss)} at {where}")
        return loss

    def _train_epoch(self, epoch: int) -> Dict:
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t_epoch = time.perf_counter()
        secs = dict.fromkeys(("host_s", "upload_s", "step_host_s"), 0.0)
        losses, marks = [], []
        n = 0
        for group in self._groups(self._use_fused(), secs):
            t1 = time.perf_counter()
            dev_batches = self.upload_group(group)
            t2 = time.perf_counter()
            secs["upload_s"] += t2 - t1
            if cuda:
                marks.append((torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True)))
                marks[-1][0].record()
            group_losses = [self._checked_step(b, epoch, n + i)
                            for i, b in enumerate(dev_batches)]
            if cuda:
                marks[-1][1].record()
            secs["step_host_s"] += time.perf_counter() - t2
            losses.extend(group_losses)
            prints = [i for i in range(len(group)) if (n + i) % 50 == 0]
            if prints:
                read = torch.stack(group_losses).tolist()
                for i in prints:
                    print(f"training: {epoch + 1} batch {n + i} "
                          f"batch_loss: {read[i]:.5f}")
            n += len(group)
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
        """Every rank gathers its sharded tables and their Adam moments;
        rank 0 writes the checkpoint, which every rank then waits for."""
        cuda = self.device.type == "cuda"
        model, optimizer = self._full_states()
        if process_index() == 0:
            save_train_state(self._ckpt_path(), {
                "epoch": epoch,
                "model": model,
                "optimizer": optimizer,
                "host_rng_state": self.host_rng.bit_generator.state,
                "torch_rng_state": torch.get_rng_state(),
                "cuda_rng_state": (torch.cuda.get_rng_state(self.device)
                                   if cuda else None),
                "generator_state": self.generator.get_state(),
                "best_user_emb": self.best_user_emb,
                "best_item_emb": self.best_item_emb,
                "best_performance": self.best_performance,
                "early_stop_patience": getattr(self, "early_stop_patience",
                                               None),
            })
        barrier()

    def _sharded_slots(self):
        """(state dict name, optimizer state index) of each sharded
        parameter."""
        index = {id(p): i for i, p in enumerate(
            p for g in self.optimizer.param_groups for p in g["params"])}
        params = dict(self.model.named_parameters())
        return [(name, index[id(params[name])])
                for name in sorted(self.sharded)]

    def _full_states(self):
        """(model, optimizer) state dicts with every sharded table and its
        Adam moments gathered whole (the live states left as they are)."""
        model = self.model.state_dict()
        optimizer = self.optimizer.state_dict()
        return self._map_sharded(
            model, optimizer, lambda t: localize(t, self.mesh.model_group))

    def _shard_states(self, model: dict, optimizer: dict):
        """The inverse of ``_full_states``: this rank's blocks of a
        checkpoint's whole tables and moments."""
        return self._map_sharded(model, optimizer,
                                 lambda t: shard_rows(self.mesh, t))

    def _map_sharded(self, model: dict, optimizer: dict, fn):
        """``fn`` applied to each sharded table of ``model`` and to its
        optimizer state tensors of the same height; new dicts returned."""
        if not self.sharded:
            return model, optimizer
        model, state = dict(model), dict(optimizer["state"])
        for name, i in self._sharded_slots():
            rows = model[name].shape[0]
            model[name] = fn(model[name])
            state[i] = {k: fn(v) if torch.is_tensor(v) and v.dim() == 2
                        and v.shape[0] == rows else v
                        for k, v in state.get(i, {}).items()}
        return model, {**optimizer, "state": state}

    def _try_resume(self) -> int:
        """Restore mid-training state; returns the epoch to resume from."""
        path = self._ckpt_path()
        if not path:
            return 0
        state = load_train_state(path)
        if state is None:
            return 0
        model, optimizer = self._shard_states(state["model"],
                                              state["optimizer"])
        self.model.load_state_dict(model)
        self.optimizer.load_state_dict(optimizer)
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
            self.current_epoch = epoch
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
        self.current_epoch = None
        self.epochs_ran = (epoch + 1) if self.max_epoch > 0 else 0
        self.timer(start=False)
        self.user_emb, self.item_emb = self.best_user_emb, self.best_item_emb
        # every rank computes the extra tensors: they may gather sharded
        # tables (CGRC's propagated tables), a collective of the group
        extra = self.extra_saved_tensors() if self.args.save_emb else {}
        if self.args.save_emb and process_index() == 0:
            save_embeddings(
                self.args.emb_dir,
                self.dataset_name,
                self.args.cold_object,
                self.model_name,
                {"user_emb": self.user_emb, "item_emb": self.item_emb,
                 **extra},
                fmt=getattr(self.args, "save_emb_format", "npz"),
            )
        if self.args.save_emb:
            barrier()  # the bus is whole before any rank goes on

    def save(self):
        # the eval tables are fresh tensors (refresh_tables), never updated
        self.best_user_emb = self.user_emb
        self.best_item_emb = self.item_emb

    def batch_scores(self, user_ids: np.ndarray) -> torch.Tensor:
        idx = torch.as_tensor(np.asarray(user_ids), device=self.device).long()
        return exact_scores(self.user_emb[idx], self.item_emb)


def _shapes(batch: Dict[str, np.ndarray]) -> Dict:
    return {key: v.shape for key, v in batch.items()}
