"""Trainer runtime: the contract every model of the port obeys.

The port's copy of ``coldrec_tpu/runtime/trainer.py`` (``Config``,
``BaseColdStartTrainer``; reference ColdRec model/BaseRecommender.py:13-370):

  * abstract ``train`` / ``batch_scores`` / ``save``;
  * ``run()``: train, then the three-way (overall / cold / warm) test of the
    best tables through :func:`three_way_test`;
  * ``fast_evaluation``: validation lists every ``eval_every`` epochs,
    early stopping on strict improvement of NDCG@max(topN); non-finite
    metrics never become "best" and consume patience (268-351).

Ranked lists come from :func:`rec_lists`: factored tables go through the
hand-written retrieval kernel on the card (its plain version on the CPU),
or through the plain matmul + ``masked_topk`` sweep. ``--eval_backend``
picks one: ``auto`` and ``pallas`` the kernel, ``pallas_bf16`` the kernel's
bf16 mode (the exact top-k of the bf16-rounded scores, opt-in as in the
JAX package), ``xla`` the plain sweep.
"""
from __future__ import annotations

import math
import time
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.builder import ColdStartDataset
from ..device import resolve_device
from ..ops.cuda.retrieval import launch_counts
from ..utils.logging import event_log
from ..utils.metrics import ranking_evaluation
from .eval import EvalSweep, exact_scores

SETTING_SPLITS = {
    ("all", "valid"): "overall_val",
    ("cold", "valid"): "cold_val",
    ("warm", "valid"): "warm_val",
    ("all", "test"): "overall_test",
    ("cold", "test"): "cold_test",
    ("warm", "test"): "warm_test",
}

METRIC_NAMES = ["Hit Ratio", "Precision", "Recall", "NDCG"]
BACKENDS = ("kernel", "kernel_bf16", "plain")
# --eval_backend of the JAX CLI -> the port's sweep
EVAL_BACKENDS = {"auto": "kernel", "pallas": "kernel",
                 "pallas_bf16": "kernel_bf16", "xla": "plain"}


def eval_backend(flag: str) -> str:
    """The port's sweep (``"kernel"``, ``"kernel_bf16"`` or ``"plain"``)
    for ``--eval_backend``."""
    if flag not in EVAL_BACKENDS:
        raise ValueError(f"--eval_backend {flag!r} not in "
                         f"{sorted(EVAL_BACKENDS)}")
    return EVAL_BACKENDS[flag]


def rec_lists(
    sweep: EvalSweep,
    phase: str,
    data_type: str,
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    backend: str = "kernel",
) -> np.ndarray:
    """(n_users, max_N) ranked mapped item ids for one (phase, setting).

    ``backend="kernel"`` sends factored tables through the retrieval kernel
    (``"kernel_bf16"``: its bf16 mode); a split with a user rated too
    heavily for the kernel's candidate stream goes to the exact fp32 plain
    sweep, as in the JAX package. ``"plain"`` always takes the plain sweep
    (matmul + ``masked_topk``). The route taken is sent to the event log
    (``sweep_route``)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    split = SETTING_SPLITS[(data_type, phase)]
    route = "plain"
    if backend != "plain" and sweep.kernel_supported(split, data_type):
        route = backend
    event_log().emit("sweep_route", split=split, backend=backend,
                     route=route)
    if route != "plain":
        return sweep.run_kernel(split, data_type, user_emb, item_emb,
                                bf16=route == "kernel_bf16")

    def score_fn(users: np.ndarray) -> torch.Tensor:
        idx = torch.as_tensor(users, device=user_emb.device).long()
        return exact_scores(user_emb[idx], item_emb)

    return sweep.run(split, data_type, score_fn)


def three_way_test(
    data,
    user_emb,
    item_emb,
    topN: Sequence[int] = (10, 20),
    cold_object: str = "item",
    batch_size: int = 2048,
    backend: str = "kernel",
    device="cuda",
    verbose: bool = True,
    sweep: Optional[EvalSweep] = None,
) -> Dict[str, dict]:
    """Test under the all / cold / warm settings.

    Returns ``{setting: {"rec": (n, max_N) ids, "measure": lines,
    "performance": [[hr, prec, recall, ndcg] per n]}}`` and, with
    ``verbose``, prints each setting's metric lines. ``sweep`` reuses a
    prepared :class:`EvalSweep` (a trainer's) in place of a new one."""
    if sweep is None:
        sweep = EvalSweep(data, cold_object, batch_size, max(topN),
                          device=device)
    ue = torch.as_tensor(user_emb, dtype=torch.float32, device=sweep.device)
    ie = torch.as_tensor(item_emb, dtype=torch.float32, device=sweep.device)
    out: Dict[str, dict] = {}
    for test_type in ("all", "cold", "warm"):
        rec = rec_lists(sweep, "test", test_type, ue, ie, backend=backend)
        es = data.eval_splits[SETTING_SPLITS[(test_type, "test")]]
        measure, perf = ranking_evaluation(
            es.indptr, es.items, rec, list(topN), data.item_num
        )
        out[test_type] = {"rec": rec, "measure": measure, "performance": perf}
        if verbose:
            print(f"[{test_type} setting] " + "  ".join(
                m.strip() for m in measure))
    return out


class Config:
    """Bundles parsed args + built dataset (reference: main.py Config).
    ``epoch_steps`` > 0 cuts every training epoch to its first that many
    batches (a short run of the full-width model); 0 trains whole epochs."""

    def __init__(self, args, data: Optional[ColdStartDataset] = None,
                 epoch_steps: int = 0):
        self.args = args
        if data is None:
            data = ColdStartDataset.from_split_dir(
                args.data_dir, args.dataset, args.cold_object
            )
        self.data = data
        self.epoch_steps = int(epoch_steps)


class BaseColdStartTrainer(ABC):
    """The trainer contract. Subclasses set ``user_emb`` / ``item_emb`` (the
    eval tables on ``self.device``) and implement ``train``,
    ``batch_scores`` and ``save``."""

    def __init__(self, config: Config):
        self.config = config
        self.args = config.args
        self.data: ColdStartDataset = config.data
        self.device = resolve_device(getattr(self.args, "device", "cuda"))
        self.eval_backend = eval_backend(
            str(getattr(self.args, "eval_backend", "auto")))
        self.best_performance: list = []
        self.topN = [int(x) for x in str(self.args.topN).split(",")]
        self.max_N = max(self.topN)
        self.model_name = self.args.model
        self.dataset_name = self.args.dataset
        self.emb_size = int(self.args.emb_size)
        self.max_epoch = int(self.args.epochs)
        self.batch_size = int(self.args.bs)
        self.lr = float(self.args.lr)
        self.reg = float(self.args.reg)
        self.result: List[str] = []
        self.early_stop_flag = int(self.args.early_stop) != 0
        if self.early_stop_flag:
            self.early_stop_patience = int(self.args.early_stop)
            self.max_early_stop_patience = int(self.args.early_stop)
        self.epochs_ran = 0
        self.eval_every = max(1, int(getattr(self.args, "eval_every", 1)))
        # prepared once per split and kept across epochs: the tables change,
        # the users, rated ids and exclusion rows do not
        self.sweep = EvalSweep(
            self.data, self.args.cold_object, self.batch_size, self.max_N,
            device=self.device,
        )
        self.user_emb: Optional[torch.Tensor] = None
        self.item_emb: Optional[torch.Tensor] = None
        self.overall_test_results = None
        self.cold_test_results = None
        self.warm_test_results = None
        self.test_results = None  # run()'s three_way_test output
        self.train_start_time = 0.0
        self.train_end_time = 0.0
        # host RNG for the samplers, consumed as the JAX package does
        self.seed = int(getattr(self.args, "seed", 2024))
        self.host_rng = np.random.default_rng(self.seed)
        # the device's draws of a step (e.g. DropoutNet's dropped rows)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self.events = event_log()
        self.events.emit(
            "run_start",
            model=self.model_name,
            dataset=self.dataset_name,
            cold_object=self.args.cold_object,
            emb_size=self.emb_size,
            seed=self.seed,
            device=str(self.device),
        )

    # ------------------------------------------------------------- contract
    @abstractmethod
    def train(self) -> None:
        ...

    @abstractmethod
    def batch_scores(self, user_ids: np.ndarray) -> torch.Tensor:
        """(len(user_ids), item_num) scores for mapped user ids."""
        ...

    @abstractmethod
    def save(self) -> None:
        """Snapshot the current (best) eval-ready state."""
        ...

    def predict(self, raw_user) -> np.ndarray:
        """Scores over all items for one raw user id (reference predict())."""
        return self.batch_predict([raw_user])[0]

    def batch_predict(self, raw_users) -> np.ndarray:
        """(len(raw_users), item_num) scores for a list of raw user ids
        (reference batch_predict(), MF.py:58-63)."""
        uid = self.data.map_users(np.asarray(raw_users))
        return self.batch_scores(uid).cpu().numpy()

    # ------------------------------------------------------------- plumbing
    def timer(self, start: bool = True):
        if start:
            self.train_start_time = time.time()
        else:
            self.train_end_time = time.time()

    def print_basic_info(self):
        print("*" * 80)
        print("Model: ", self.model_name)
        print("Dataset: ", self.dataset_name)
        print("Embedding Dimension:", self.emb_size)
        print("Maximum Epoch:", self.max_epoch)
        print("Learning Rate:", self.lr)
        print("Batch Size:", self.batch_size)
        print("*" * 80)

    # ----------------------------------------------------------------- eval
    def valid(self, valid_type: str = "all") -> np.ndarray:
        return rec_lists(self.sweep, "valid", valid_type, self.user_emb,
                         self.item_emb, backend=self.eval_backend)

    def test(self, test_type: str = "all") -> np.ndarray:
        return rec_lists(self.sweep, "test", test_type, self.user_emb,
                         self.item_emb, backend=self.eval_backend)

    def _evaluate_split(self, phase: str, data_type: str, rec: np.ndarray,
                        topN: Sequence[int]):
        es = self.data.eval_splits[SETTING_SPLITS[(data_type, phase)]]
        return ranking_evaluation(
            es.indptr, es.items, rec, list(topN), self.data.item_num
        )

    def fast_evaluation(self, epoch: int, valid_type: str = "all") -> List[str]:
        print(f"Evaluating the model under the {valid_type} setting...")
        rec = self.valid(valid_type)
        measure, perf = self._evaluate_split(
            "valid", valid_type, rec, [self.max_N]
        )
        performance: Dict[str, float] = dict(zip(METRIC_NAMES, perf[0]))
        finite = all(math.isfinite(v) for v in performance.values())

        self.events.emit(
            "validation",
            epoch=epoch + 1,
            setting=valid_type,
            **{k.replace(" ", "_").lower(): v for k, v in performance.items()},
        )
        if self.best_performance:
            if not finite:
                if self.early_stop_flag:
                    self.early_stop_patience -= 1
                print(
                    "Warning: validation metrics are non-finite; "
                    "early-stop patience decreased, best checkpoint unchanged."
                )
            else:
                if performance["NDCG"] > self.best_performance[1]["NDCG"]:
                    self.best_performance[1] = performance
                    self.best_performance[0] = epoch + 1
                    self.save()
                    if self.early_stop_flag:
                        self.early_stop_patience = self.max_early_stop_patience
                elif self.early_stop_flag:
                    self.early_stop_patience -= 1
        else:
            if finite:
                self.best_performance = [epoch + 1, performance]
                self.save()
            elif self.early_stop_flag:
                self.early_stop_patience -= 1

        measure_lines = [m.strip() for m in measure[1:]]
        print("-" * 100)
        print(f"Performance (Top-{self.max_N} Recommendation)")
        print("Epoch:", str(epoch + 1) + ",", "  |  ".join(measure_lines))
        if self.best_performance:
            bp = "  |  ".join(
                f"{k}:{v}" for k, v in self.best_performance[1].items()
            )
            print(f"*Best {valid_type} Performance*")
            print("Epoch:", str(self.best_performance[0]) + ",", bp)
        if self.early_stop_flag:
            if self.early_stop_patience <= 0:
                print(f"Stopping early at epoch {epoch + 1}.")
            else:
                print(f"Early stopping patience left: {self.early_stop_patience}.")
        print("-" * 100)
        return measure_lines

    def should_stop(self) -> bool:
        return self.early_stop_flag and self.early_stop_patience <= 0

    # ------------------------------------------------------------------ run
    def run(self):
        self.print_basic_info()
        print("Training Model...")
        self.train()
        if self.epochs_ran == 0 and self.max_epoch > 0:
            self.epochs_ran = self.max_epoch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        res = three_way_test(
            self.data, self.user_emb, self.item_emb, topN=self.topN,
            backend=self.eval_backend, device=self.device, verbose=False,
            sweep=self.sweep,
        )
        test_seconds = time.perf_counter() - t
        self.test_results = res  # the lists and metrics of each setting
        for test_type in ("all", "cold", "warm"):
            print("*" * 80)
            print(f"Testing under [{test_type}] setting...")
            measure = res[test_type]["measure"]
            self.result = measure
            setattr(self, {"all": "overall_test_results",
                           "cold": "cold_test_results",
                           "warm": "warm_test_results"}[test_type],
                    res[test_type]["performance"])
            print("*" * 80)
            print(
                f"[{test_type} setting] The result of {self.model_name}:\n"
                + "".join(measure)
            )
        self.events.emit(
            "run_end",
            model=self.model_name,
            epochs_ran=self.epochs_ran,
            train_seconds=round(self.train_end_time - self.train_start_time, 3),
            test_seconds=test_seconds,
            overall=self.overall_test_results,
            cold=self.cold_test_results,
            warm=self.warm_test_results,
            kernel_launches=launch_counts(),
        )
