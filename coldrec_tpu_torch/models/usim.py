"""USIM RL embedding refinement (the port's copy of
``coldrec_tpu/models/usim.py``; reference: model/USIM.py). Item cold start
only.

A content-mapped initial state is nudged toward the (frozen) backbone item
embedding by a discrete actor that picks warm users (and an appended stop
token): ``s += u * rate`` (USIM.py:551-570). Reward = distance-to-item
improvement + top-10 score alignment with log discount (473-522). PPO-clip
with target nets, 5 inner epochs (350-409); per batch the buffer is filled
by 3 rollouts and cleared (844-857), so optimization always consumes the
current batch's transitions. Masked action sampling combines
positive-direction top-k ∧ item-score top-k, random negatives, the stop
token and the 20% argmax-exclusion trick (668-759), quirks kept: the
excluded argmax collapses to user 0 when the 20% draw does not select it.
Inference is a greedy rollout from the content state (524-549); scoring
uses the frozen backbone user table with warm and cold item columns
(594-600; unclassified items score 0).

As in the JAX package, all ``max_time`` steps of a rollout always run (done
envs add zero-reward frozen-state transitions), masks are kept as their
support columns (at most 2k + 1 per row) and never as (T, n_user) planes,
and the content mapper is never optimized. PPO runs over the whole
transition set when ``T * n_user <= _DENSE_OPT_ELEMS``, else in chunks of
the batch size, the gradients of every chunk accumulated in ``.grad``
before one step of each optimizer per PPO iteration. The optimizers are
``torch.optim.Adam`` with coupled weight decay (optax's
``chain(add_decayed_weights, adam)``).

A batch's draws (per rollout and step: the negative users, the exclusion
uniform, the Gumbel noise of the categorical; per batch: the termination
times) come from the trainer's generator on its device in one call
(``USIMTrainer.draw``), or from ``draws=`` (the tests hand it the JAX
package's). ``jax.random.categorical`` is ``argmax(logits + gumbel)``, and
the port samples the same way. ``USIM.marks``, when a list, gets a
(phase, host time, CUDA event) at each phase boundary of a batch step, and
``USIM.trace`` the noisy logits (logits + Gumbel) of every sampling step.
"""
from __future__ import annotations

import copy
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..runtime.eval import stable_topk
from .cold_base import ColdStartModelBase
from .common import JaxCarried, linear_params, linear_slots, xavier_uniform
from .warm_base import OptimizerGroups

REWARD_TOPK = 10  # hardcoded in the reference (USIM.py:495,504)
ROLLOUTS = 3  # rollouts per batch (USIM.py:844-857)


def _stream_topk(x: torch.Tensor, k: int, seg: int = 4096):
    """Exact top-k over a wide trailing axis, ``lax.top_k``'s order (values
    descending, ties lowest index first). The JAX package merges segments of
    ``seg`` columns in a scan to bound its sort temporaries; the flat
    :func:`stable_topk` gives the same values and ids at every ``seg``,
    which is kept so that callers read as the JAX package's."""
    del seg
    return stable_topk(x, min(k, x.shape[1]))


def _probs(actor: nn.ModuleDict, table: torch.Tensor,
           state: torch.Tensor) -> torch.Tensor:
    """[softmax(map(s) @ users.T) * P(continue) ∥ P(stop)] (USIM.py:75-88):
    the oracle of the tests, never on the production path."""
    emb = actor["map"](state)
    end = torch.softmax(actor["end_map"](state), dim=-1)
    ap = torch.softmax(emb @ table.T, dim=-1)
    return torch.cat([ap * end[:, :1], end[:, 1:2]], dim=-1)


def _critic_of(critic: nn.ModuleDict, s: torch.Tensor) -> torch.Tensor:
    return critic["fc1"](s)[:, 0]


def _row_lse(z: torch.Tensor):
    """(logsumexp, max, first argmax) of each row of ``z``, by
    ``torch.logsumexp``'s own steps (the row max, a non-finite max taken as
    0, then the log of the sum of exp(z - max)), the max and its index read
    in one pass."""
    zmax, arg = z.max(dim=1)
    shift = torch.where(zmax.isinf(), 0.0, zmax)
    s = (z - shift[:, None]).exp_().sum(dim=1)
    return s.log_() + shift, zmax, arg


class LogSumExpProduct(torch.autograd.Function):
    """logsumexp over each row of z = emb @ table.T, differentiable in
    ``emb`` (``table`` is frozen). The forward turns its own z plane into e =
    exp(z - max) in place and keeps it with the row sums s, so the backward
    is one product: d lse / d emb = softmax(z) @ table = (e @ table) / s.
    Autograd of ``torch.logsumexp`` keeps z and forms exp(z - lse) and the
    gradient plane in its backward: about 20 passes over a (rows, users)
    plane a PPO chunk against 8."""

    @staticmethod
    def forward(ctx, emb, table):
        z = emb @ table.T
        zmax = z.amax(dim=1)
        shift = torch.where(zmax.isinf(), 0.0, zmax)
        e = z.sub_(shift[:, None]).exp_()
        s = e.sum(dim=1)
        ctx.save_for_backward(e, s, table)
        return s.log() + shift

    @staticmethod
    def backward(ctx, g):
        e, s, table = ctx.saved_tensors
        return (e @ table) * (g / s)[:, None], None


class USIM(JaxCarried, nn.Module):
    """The nets (``actor``: map, end_map; ``critic``: fc1; their targets;
    ``mapper``: fc1, fc2, frozen), the frozen tables as non-persistent
    buffers, and the RL math of one batch."""

    _DENSE_OPT_ELEMS = 1 << 29  # T * n_user fp32 elements (2 GiB planes)

    def __init__(self, user_table: torch.Tensor, item_table: torch.Tensor,
                 content: torch.Tensor, col_mask: torch.Tensor, hidden: int,
                 max_time: int, rate: float, k: int, weight: float,
                 reward_cost: float, discount: float, seed: int = 2024,
                 device="cuda"):
        super().__init__()
        d = int(user_table.shape[1])
        gen = torch.Generator().manual_seed(int(seed))
        self.actor = nn.ModuleDict({"map": linear_params(d + 1, d, gen),
                                    "end_map": linear_params(d + 1, 2, gen)})
        self.critic = nn.ModuleDict({"fc1": linear_params(d + 1, 1, gen)})
        self.mapper = nn.ModuleDict({
            "fc1": linear_params(int(content.shape[1]), hidden, gen),
            "fc2": linear_params(hidden, d, gen)})
        self.target_actor = copy.deepcopy(self.actor)
        self.target_critic = copy.deepcopy(self.critic)
        for net in (self.mapper, self.target_actor, self.target_critic):
            net.requires_grad_(False)
        user_ext = torch.cat([user_table, user_table.new_zeros((1, d))])
        norms = user_ext.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        for name, value in (("user_table", user_table),
                            ("item_table", item_table),
                            ("user_ext", user_ext),
                            ("norm_mat", user_ext / norms),
                            ("content", content), ("col_mask", col_mask)):
            self.register_buffer(name, value, persistent=False)
        self.n_user = int(user_ext.shape[0])  # U + 1 (stop)
        self.max_time = int(max_time)
        self.rate = float(rate)
        self.k = int(k)
        self.weight = float(weight)
        self.reward_cost = float(reward_cost)
        self.discount = float(discount)
        # PPO gradient passes per batch (reference USIM.py:431)
        self.n_ppo = 5
        self.marks: Optional[list] = None
        self.trace: Optional[list] = None
        self.to(device)

    def jax_slots(self) -> list:
        layers = (("actor", "map"), ("actor", "end_map"), ("critic", "fc1"),
                  ("target_actor", "map"), ("target_actor", "end_map"),
                  ("target_critic", "fc1"), ("mapper", "fc1"),
                  ("mapper", "fc2"))
        return [s for net, name in layers
                for s in linear_slots(getattr(self, net)[name],
                                      ("params", net, name))]

    @property
    def cands_width(self) -> int:
        """Support columns of a row: pos top-k, k negatives and the stop."""
        return min(self.k, self.n_user) + self.k + 1

    def _mark(self, phase: str) -> None:
        if self.marks is not None:
            ev = None
            if self.user_table.is_cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
            self.marks.append((phase, time.perf_counter(), ev))

    # ------------------------------------------------------------- RL core
    def _map_content(self, content: torch.Tensor) -> torch.Tensor:
        m = self.mapper
        return m["fc2"](torch.relu(m["fc1"](content)))

    def _target_topk(self, item_emb: torch.Tensor):
        """The reward's target alignment columns (USIM.py:473-522), a
        function of item_emb alone: top-10 over ``user_ext`` with the stop
        row (``topk_user`` leaves it out)."""
        return _stream_topk(item_emb @ self.user_ext.T, REWARD_TOPK)

    def _reward(self, item_emb, state, action, dones, tops=None):
        sim1 = torch.linalg.vector_norm(item_emb - state, dim=1)
        nxt = state + self.user_ext[action] * self.rate
        sim2 = torch.linalg.vector_norm(item_emb - nxt, dim=1)
        top_s, idx = self._target_topk(item_emb) if tops is None else tops
        # the state against the REWARD_TOPK selected user columns alone
        user_sel = self.user_ext[idx]
        st_s = torch.einsum("bd,bkd->bk", state, user_sel)
        nx_s = torch.einsum("bd,bkd->bk", nxt, user_sel)
        differ = (top_s - st_s).abs() - (top_s - nx_s).abs()
        discount = torch.log2(torch.arange(
            REWARD_TOPK, device=state.device, dtype=state.dtype) + 2.0)
        differ = differ / discount
        r1 = self.weight * (sim1 - sim2) + (1 - self.weight) * differ.mean(
            dim=-1)
        return (r1 - self.reward_cost) * (1.0 - dones.to(state.dtype))

    def _z_lse(self, actor: nn.ModuleDict, states: torch.Tensor,
               with_max: bool = False):
        """The actor's logits row over the users, its logsumexp and the
        [continue, stop] head: sp[u] = end0 * exp(z_u - lse), sp[stop] =
        end1 (USIM.py:75-88), so the softmax plane is never formed. With
        ``with_max`` also the row max and its first index (no gradient)."""
        emb = actor["map"](states)
        end = torch.softmax(actor["end_map"](states), dim=-1)
        z = emb @ self.user_table.T  # (B, n_user - 1)
        lse, zmax, arg = _row_lse(z)
        return (z, lse, end, zmax, arg) if with_max else (z, lse, end)

    def _sp_at(self, cands, z, lse, end):
        """sp gathered at the candidate columns (stop column = end1)."""
        is_stop = cands == self.n_user - 1
        z_c = z.gather(1, torch.where(is_stop, 0, cands))
        return _sp_of(is_stop, z_c, lse, end)

    def _support_columns(self, pos_idx, user_idx, neg_idx, masked_am):
        """The support of the reference's mask plane (USIM.py:668-759) as
        candidate columns and keep flags with set semantics: a column
        survives iff its id is mask-selected, is not the excluded argmax,
        and no earlier kept column holds the same id (OR-dedup)."""
        in_user = (pos_idx[:, :, None] == user_idx[:, None, :]).any(dim=-1)
        empty = ~in_user.any(dim=-1, keepdim=True)
        w = torch.cat([in_user | empty,
                       torch.ones(neg_idx.shape, dtype=torch.bool,
                                  device=neg_idx.device)], dim=1)
        cands = torch.cat([pos_idx, neg_idx], dim=1)
        c = cands.shape[1]
        eq = cands[:, :, None] == cands[:, None, :]  # [b, j, i]
        lower = torch.ones((c, c), dtype=torch.bool,
                           device=cands.device).tril(-1)
        dup = (eq & lower[None] & w[:, None, :]).any(dim=-1)
        keep = w & ~dup & (cands != masked_am[:, None])
        return cands, keep

    def _sample_mask(self, state, item_emb, draws, target_actor, state_time,
                     topk_user=None):
        """Masked exploration (USIM.py:668-759) over the support columns
        (the categorical is renormalization-invariant); ``draws`` holds the
        step's ``neg`` (B, k), ``unif`` (B,) and ``gumbel`` (B, 2k + 1).
        Returns (action, pos_idx, user_idx, neg_idx, masked_argmax)."""
        b = state.shape[0]
        dvec = item_emb - state
        dn = dvec / dvec.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        sim = dn @ self.norm_mat.T  # (B, n_user)
        if topk_user is None:
            topk_user = _stream_topk(item_emb @ self.user_table.T,
                                     min(self.k, self.n_user - 1))[1]
        pos_idx = _stream_topk(sim, min(self.k, self.n_user))[1]
        neg = draws["neg"].long()
        stop_col = torch.full((b, 1), self.n_user - 1, dtype=neg.dtype,
                              device=neg.device)
        neg_idx = torch.cat([neg, stop_col], dim=1)
        index_state = torch.cat([state, state_time[:, None]], dim=1)
        z, lse, end, zmax, arg = self._z_lse(target_actor, index_state,
                                             with_max=True)
        # argmax of sp: user columns first (ties -> earlier), stop last
        best_user = end[:, 0] * torch.exp(zmax - lse)
        am = torch.where(best_user >= end[:, 1], arg, self.n_user - 1)
        rand = draws["unif"] > 0.8
        masked_am = torch.where(rand, am, 0)  # reference quirk: user 0
        cands, keep = self._support_columns(pos_idx, topk_user, neg_idx,
                                            masked_am)
        sp_c = self._sp_at(cands, z, lse, end)
        noisy = torch.log(torch.clamp_min(sp_c * keep, 1e-20)) \
            + draws["gumbel"]
        if self.trace is not None:
            self.trace.append(noisy)
        col = noisy.argmax(dim=1)
        action = cands.gather(1, col[:, None])[:, 0]
        return action, pos_idx, topk_user, neg_idx, masked_am

    @staticmethod
    def _rebuild_mask(n_user, pos_idx, user_idx, neg_idx, masked_am):
        """(T, n_user) bool mask plane: the reference's mask algebra
        transcribed, the oracle of the support form (never on the path)."""
        t = pos_idx.shape[0]

        def onehot_any(idx):
            out = torch.zeros((t, n_user), dtype=torch.bool,
                              device=idx.device)
            return out.scatter_(1, idx.long(), True)

        oh_pos = onehot_any(pos_idx)
        mask = oh_pos & onehot_any(user_idx)
        empty = mask.sum(dim=-1) == 0
        mask = torch.where(empty[:, None], oh_pos, mask)
        mask = mask | onehot_any(neg_idx)
        return mask & ~onehot_any(masked_am[:, None])

    def _log_probs_masked(self, actor, states, actions, idxs):
        """log of the renormalized masked policy at the taken action:
        log(sp[a] / Σ_support sp), the Σ over the kept candidate columns.
        The logits at the candidate and action columns are products with
        the gathered user rows, the logsumexp :class:`LogSumExpProduct`:
        no gradient plane is formed."""
        pos_idx, user_idx, neg_idx, masked_am = idxs
        emb = actor["map"](states)
        end = torch.softmax(actor["end_map"](states), dim=-1)
        lse = LogSumExpProduct.apply(emb, self.user_table)
        cands, keep = self._support_columns(pos_idx, user_idx, neg_idx,
                                            masked_am)
        cols = torch.cat([cands, actions[:, None]], dim=1)
        is_stop = cols == self.n_user - 1
        z_cols = torch.einsum("bd,bcd->bc", emb, self.user_table[
            torch.where(is_stop, 0, cols)])
        sp = _sp_of(is_stop, z_cols, lse, end)
        sigma = (sp[:, :-1] * keep).sum(dim=1)
        sp_a = sp[:, -1]
        kept_a = ((cands == actions[:, None]) & keep).any(dim=1)
        sp_a = sp_a * kept_a  # mask[a] = 0 -> log(1e-20), as the plane
        return torch.log(torch.clamp_min(sp_a / sigma.clamp_min(1e-12),
                                         1e-20))

    # ------------------------------------------------------------- a batch
    @torch.no_grad()
    def _rollouts(self, items, valid, draws):
        """The hoisted top-ks, then 3 rollouts of ``max_time`` steps from the
        content state; returns the transitions, rollout-major and
        step-major, as flat (T, ...) tensors, and the item rows."""
        item_emb = self.item_table[items]
        content = self.content[items]
        # both depend on item_emb alone: hoisted out of the rollout steps
        topk_user = _stream_topk(item_emb @ self.user_table.T,
                                 min(self.k, self.n_user - 1))[1]
        tops = self._target_topk(item_emb)
        state0 = self._map_content(content)
        self._mark("hoisted top-ks")
        b = items.shape[0]
        keys = ("state", "action", "reward", "next", "dones", "pos", "user",
                "neg", "mam", "w")
        out = {k: [] for k in keys}
        for r in range(ROLLOUTS):
            state = state0
            dones = torch.zeros(b, dtype=torch.bool, device=items.device)
            st = torch.full((b,), float(self.max_time), device=items.device)
            for t in range(self.max_time):
                step = {k: draws[k][r, t] for k in ("neg", "unif", "gumbel")}
                action, pos_i, user_i, neg_i, mam = self._sample_mask(
                    state, item_emb, step, self.target_actor, st,
                    topk_user=topk_user)
                reward = self._reward(item_emb, state, action, dones, tops)
                ue = self.user_ext[action] * (1.0 - dones.float())[:, None]
                next_state = state + ue * self.rate
                new_dones = dones | (action == self.n_user - 1)
                for k, v in zip(keys, (
                        torch.cat([state, st[:, None]], dim=1), action,
                        reward, torch.cat([next_state, (st - 1)[:, None]],
                                          dim=1),
                        new_dones, pos_i, user_i, neg_i, mam, valid)):
                    out[k].append(v)
                state, dones, st = next_state, new_dones, st - 1
        self._mark("rollouts")
        trans = {k: torch.cat(v) for k, v in out.items()}
        trans["dones"] = trans["dones"].float()
        return trans, item_emb

    def _batch_step(self, items, valid, draws, actor_opt, critic_opt):
        """One USIM batch: 3 rollouts -> PPO(5) -> termination step -> hard
        update of the target nets; the weights and the optimizers' states
        change in place. Returns {"actions": (3, max_time, B), "losses":
        [actor, critic] per PPO iteration then the termination loss}."""
        self._mark("start")
        items = items.long()
        trans, item_emb = self._rollouts(items, valid, draws)
        if trans["state"].shape[0] * self.n_user <= self._DENSE_OPT_ELEMS:
            losses = self._optimize_dense(trans, actor_opt, critic_opt)
        else:
            # book-crossing scale: a (T, n_user) plane is 31.7 GB; chunks
            # of the batch size, the sums over transitions exact
            losses = self._optimize_chunked(trans, actor_opt, critic_opt,
                                            items.shape[0])
        # termination-state critic regression (USIM.py:449-455)
        rand_t = draws["rand_t"].to(item_emb.dtype)
        term_state = torch.cat([item_emb, rand_t[:, None]], dim=1)
        q = _critic_of(self.critic, term_state)
        term = (q ** 2 * valid).sum() / valid.sum().clamp_min(1.0)
        critic_opt.zero_grad(set_to_none=True)
        term.backward()
        critic_opt.step()
        # hard update
        with torch.no_grad():
            for src, dst in ((self.actor, self.target_actor),
                             (self.critic, self.target_critic)):
                for p, q_ in zip(src.parameters(), dst.parameters()):
                    q_.copy_(p)
        self._mark("termination")
        b = items.shape[0]
        return {"actions": trans["action"].view(ROLLOUTS, self.max_time, b),
                "losses": torch.cat([torch.stack(losses).view(-1),
                                     term.detach()[None]])}

    def _targets(self, tr):
        """The fixed PPO targets of a set of transitions: the target
        actor's log-probs, the critic targets and the advantages."""
        with torch.no_grad():
            lp = self._log_probs_masked(self.target_actor, tr["state"],
                                        tr["action"], _idxs(tr))
            q = tr["reward"] + self.discount * _critic_of(
                self.target_critic, tr["next"]) * (1 - tr["dones"])
            adv = q - _critic_of(self.target_critic, tr["state"])
        return lp, q, adv

    def _ppo_losses(self, tr, tlp, tq, adv, w_sum):
        lp = self._log_probs_masked(self.actor, tr["state"], tr["action"],
                                    _idxs(tr))
        ratio = torch.exp(lp - tlp)
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 0.8, 1.2) * adv
        la = (-torch.minimum(surr1, surr2) * tr["w"]).sum() / w_sum
        q = _critic_of(self.critic, tr["state"])
        lc = ((q - tq) ** 2 * tr["w"]).sum() / w_sum
        return la, lc

    def _optimize_dense(self, tr, actor_opt, critic_opt):
        """PPO(5) over the whole transition set; returns [actor, critic]
        losses per iteration."""
        w_sum = tr["w"].sum().clamp_min(1.0)
        tlp, tq, adv = self._targets(tr)
        self._mark("ppo targets")
        losses = []
        for i in range(self.n_ppo):
            la, lc = self._ppo_losses(tr, tlp, tq, adv, w_sum)
            actor_opt.zero_grad(set_to_none=True)
            critic_opt.zero_grad(set_to_none=True)
            (la + lc).backward()
            actor_opt.step()
            critic_opt.step()
            losses.append(torch.stack([la.detach(), lc.detach()]))
            self._mark(f"ppo {i + 1}")
        return losses

    def _optimize_chunked(self, tr, actor_opt, critic_opt, chunk):
        """The same PPO with transitions in chunks of ``chunk``: each
        chunk's gradients accumulate in ``.grad``, one step of each
        optimizer per PPO iteration. T = 3 * max_time * bs is a multiple of
        the chunk."""
        t_total = tr["state"].shape[0]
        w_sum = tr["w"].sum().clamp_min(1.0)
        parts = [{k: v[s:s + chunk] for k, v in tr.items()}
                 for s in range(0, t_total, chunk)]
        targets = [self._targets(p) for p in parts]
        self._mark("ppo targets")
        losses = []
        for i in range(self.n_ppo):
            actor_opt.zero_grad(set_to_none=True)
            critic_opt.zero_grad(set_to_none=True)
            la_sum = lc_sum = 0.0
            for p, (tlp, tq, adv) in zip(parts, targets):
                la, lc = self._ppo_losses(p, tlp, tq, adv, w_sum)
                (la + lc).backward()
                la_sum = la_sum + la.detach()
                lc_sum = lc_sum + lc.detach()
            actor_opt.step()
            critic_opt.step()
            losses.append(torch.stack([la_sum, lc_sum]))
            self._mark(f"ppo {i + 1}")
        return losses

    # ------------------------------------------------------------ inference
    @torch.no_grad()
    def _infer(self, actor, content, with_actions=False):
        """Greedy rollout -> final states (USIM.py:524-549): within the user
        columns softmax is monotone in z (same argmax, first index on
        ties), and the stop column wins only when end1 > end0 * exp(zmax -
        lse). With ``with_actions`` also the (B, max_time) actions."""
        state = self._map_content(content)
        b = content.shape[0]
        dones = torch.zeros(b, dtype=torch.bool, device=content.device)
        st = torch.full((b,), float(self.max_time), device=content.device)
        actions = []
        for _ in range(self.max_time):
            _, lse, end, zmax, arg = self._z_lse(
                actor, torch.cat([state, st[:, None]], 1), with_max=True)
            best_user = end[:, 0] * torch.exp(zmax - lse)
            action = torch.where(best_user >= end[:, 1], arg,
                                 self.n_user - 1)
            ue = self.user_ext[action] * (1.0 - dones.float())[:, None]
            state = state + ue * self.rate
            dones = dones | (action == self.n_user - 1)
            st = st - 1
            actions.append(action)
        if with_actions:
            return state, torch.stack(actions, dim=1)
        return state


def _sp_of(is_stop, z_c, lse, end):
    """sp at columns whose logits are ``z_c`` (the stop column: end1)."""
    return torch.where(is_stop, end[:, 1:2],
                       end[:, :1] * torch.exp(z_c - lse[:, None]))


def _idxs(tr):
    return tr["pos"], tr["user"], tr["neg"], tr["mam"]


class USIMTrainer(ColdStartModelBase):
    """``init_params`` ({"actor", "critic", "target_actor",
    "target_critic", "mapper"} of the JAX trainer, numpy leaves) replaces
    the seeded weights; both packages' Adam states start at zero."""

    _infer_blk = 4096  # cold items per greedy-rollout chunk

    # the JAX trainer never sets up a mesh: --mesh runs on one device
    mesh_support = "one_device"

    def __init__(self, config, init_params: Optional[Dict] = None):
        if config.args.cold_object != "item":
            raise ValueError("USIM only supports item cold-start")
        super().__init__(config)
        a = self.args
        d = self.emb_size
        try:
            backbone = self.load_backbone()
            uw, iw = backbone["user_emb"], backbone["item_emb"]
        except FileNotFoundError:
            print("USIM: backbone not found — Xavier init fallback")
            gen = torch.Generator().manual_seed(self.seed)
            uw = xavier_uniform((self.data.user_num, d), gen, self.device)
            iw = xavier_uniform((self.data.item_num, d), gen, self.device)
        n_i = self.data.item_num
        col = np.zeros(n_i, np.float32)  # warm or cold items score
        col[self.data.mapped_warm_item_idx] = 1.0
        col[self.data.mapped_cold_item_idx] = 1.0
        self.model = USIM(
            uw, iw, self.cold_side_content,
            torch.as_tensor(col, device=self.device),
            hidden=int(a.usim_content_hidden),
            max_time=int(a.usim_max_time), rate=float(a.usim_transition_rate),
            k=int(a.usim_k), weight=float(a.usim_reward_weight),
            reward_cost=float(a.usim_reward_cost), discount=float(a.gamma),
            seed=self.seed, device=self.device)
        if init_params is not None:
            self.model.load_jax(init_params)
        self.actor_opt, self.critic_opt = make_optimizers(self.model, a)
        self.setup_optimizer(
            optimizer=OptimizerGroups(self.actor_opt, self.critic_opt))

    def batches(self):
        """One row per warm item with train interactions (USIM.py:791-818),
        the item order drawn from ``host_rng``."""
        items = np.unique(self.data.train_pairs[:, 1])
        self.host_rng.shuffle(items)
        bs = self.batch_size
        for start in range(0, items.shape[0], bs):
            chunk = items[start:start + bs]
            n = chunk.shape[0]
            out_items = np.zeros(bs, np.int32)
            out_items[:n] = chunk
            w = np.zeros(bs, np.float32)
            w[:n] = 1.0
            yield {"items": out_items, "weight": w}

    def draw(self, b: int) -> Dict[str, torch.Tensor]:
        """A batch's draws from the trainer's generator, on its device."""
        return draw_usim(self.model, b, self.generator, self.device)

    def train_step(self, batch: Dict[str, torch.Tensor],
                   draws: Optional[Dict[str, torch.Tensor]] = None
                   ) -> torch.Tensor:
        """One batch step; returns the last PPO iteration's actor + critic
        loss (no sync)."""
        if draws is None:
            draws = self.draw(batch["items"].shape[0])
        out = self.model._batch_step(batch["items"], batch["weight"], draws,
                                     self.actor_opt, self.critic_opt)
        self.last_step = out
        n = 2 * self.model.n_ppo
        return out["losses"][n - 2:n].sum()

    def _eval_tables(self):
        m = self.model
        cold = self.cold_idx
        blk = self._infer_blk
        gen = [m._infer(m.actor, m.content[cold[s:s + blk]])
               for s in range(0, cold.shape[0], blk)]
        item_emb = m.item_table.clone()
        if gen:
            item_emb[cold] = torch.cat(gen)
        # unclassified item columns score 0 (USIM.py:594-600)
        return m.user_table, item_emb * m.col_mask[:, None]

    def forward_tables(self):
        return self._eval_tables()


def make_optimizers(model: USIM, args):
    """The actor's and the critic's Adam (coupled weight decay)."""
    return (torch.optim.Adam(model.actor.parameters(),
                             lr=float(args.actor_lr),
                             weight_decay=float(args.usim_actor_weight_decay)),
            torch.optim.Adam(model.critic.parameters(),
                             lr=float(args.critic_lr),
                             weight_decay=float(
                                 args.usim_critic_weight_decay)))


def draw_usim(model: USIM, b: int, generator: torch.Generator,
              device) -> Dict[str, torch.Tensor]:
    """One batch's draws: per rollout and step the negative users
    ``neg`` (3, max_time, B, k) in [0, U), the exclusion uniform ``unif``
    (3, max_time, B) and the Gumbel noise ``gumbel`` (3, max_time, B, 2k +
    1); the termination times ``rand_t`` (B,) in [0, max_time)."""
    lead = (ROLLOUTS, model.max_time, b)
    g = generator
    neg = torch.randint(0, model.n_user - 1, lead + (model.k,), generator=g,
                        device=device)
    unif = torch.rand(lead, generator=g, device=device)
    u = torch.rand(lead + (model.cands_width,), generator=g, device=device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    rand_t = torch.randint(0, model.max_time, (b,), generator=g,
                           device=device)
    return {"neg": neg, "unif": unif, "gumbel": gumbel, "rand_t": rand_t}
