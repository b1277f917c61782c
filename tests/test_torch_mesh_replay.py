"""``chip_smoke.py``'s ``mesh_replay`` on the CPU, in a process where jax
and coldrec_tpu are blocked (``_run_blocked``): the one-rank run of a phase
mesh group takes its ranks' side of a float32 tie (a perturbed element of
SimGCL or XSimGCL on either side of 0, a cold item's top-k users in CGRC's
Ĝ swapped at an equal logit) and fails at any other difference, at data
ranks of one block that disagree and at a count of calls the ranks did not
record."""
import pytest

from test_torch_imports import _run_blocked
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

SIGNS = """
import torch
import chip_smoke as cs
from coldrec_tpu_torch.models import simgcl

g = torch.Generator().manual_seed(0)
ego = torch.randn(10, 4, generator=g) + 0.5
ego[3, 1] = 1e-7  # 1e-7 of its row's largest: a tie
noise = torch.rand(10, 4, generator=g)
tie = ego.clone()
tie[3, 1] = -1e-7


def ranks(plane, n_data=2):  # rank r holds block r % 2, one call each
    return [[plane[:5].numpy()], [plane[5:].numpy()]] * n_data


def fails(plane, text, calls=1, recs=None):
    try:
        with cs.mesh_replay("XSimGCL", recs or ranks(plane), 2):
            for _ in range(calls):
                simgcl.perturb(ego, 0.1, noise)
    except AssertionError as e:
        assert text in str(e), e
        return
    raise SystemExit(f"no failure: {text}")


with cs.mesh_replay("XSimGCL", ranks(tie), 2) as st:
    out = simgcl.perturb(ego, 0.1, noise)
want = ego + torch.sign(tie) * simgcl._normalize(noise) * 0.1
assert torch.equal(out, want), (out - want).abs().max()
assert torch.equal(out[:3], simgcl.perturb(ego, 0.1, noise)[:3])
assert (st["calls"], st["ties"], st["where"]) == (1, 1, [0]), st
assert 0 < st["worst"] <= cs.MESH_TIE_REL, st
far = ego.clone()
far[2, 0] = -far[2, 0]
fails(far, "took another sign than the ranks'")
other = ranks(tie)
other[2] = [far[:5].numpy()]
fails(tie, "perturbed it differently", recs=other)
fails(tie, "perturbed layers than the ranks'", calls=2)
print("SIGNS OK")
"""

CGRC = """
import torch
import chip_smoke as cs
from coldrec_tpu_torch.models import cgrc

torch.manual_seed(0)
m = cgrc.CGRC(30, 6, 4, 8, seed=0, device="cpu")
h, x, k = torch.randn(30, 4), torch.randn(5, 4), 6
with torch.no_grad():
    own = m.topk_users(h, x, k)
    u = int(own[0, k - 1])
    v = next(i for i in range(30) if i not in own[0].tolist())
    h[v] = h[u]  # v's logit equals u's on every cold item
    own = m.topk_users(h, x, k)
    a, b = sorted((u, v))
    assert a in own[0].tolist() and b not in own[0].tolist()
    tie = own.clone()
    tie[0][tie[0] == a] = b  # the ranks kept the other of the two
    low = own.clone()
    low[0, 0] = next(i for i in range(30) if i not in own[0].tolist()
                     and i != b)


def rec(top):
    return [(top.numpy(), cs.edge_scores(m, h, x, top).numpy())]


def fails(recs, text):
    try:
        with cs.mesh_replay("CGRC", recs, 2):
            with torch.no_grad():
                m.topk_users(h, x, k)
    except AssertionError as e:
        assert text in str(e), e
        return
    raise SystemExit(f"no failure: {text}")


with cs.mesh_replay("CGRC", [rec(tie)] * 4, 2) as st:
    with torch.no_grad():
        got = m.topk_users(h, x, k)
assert torch.equal(got, tie), (got, tie)
assert (st["calls"], st["ties"], st["where"]) == (1, 1, [1]), st
assert st["worst"] == 0.0 and st["drift"] == 0.0, st
fails([rec(low)] * 4, "differ from one rank's on 1 cold items")
fails([rec(tie)] * 3 + [rec(own)], "rank 3 built another")
shifted = [(tie.numpy(), cs.edge_scores(m, h, x, tie).numpy() * 1.01)]
fails([shifted] * 4, "logits")
print("CGRC OK")
"""


@pytest.mark.parametrize("case", ["signs", "cgrc"])
def test_mesh_replay_takes_ties_and_fails_otherwise(case, tmp_path):
    code, ok = {"signs": (SIGNS, "SIGNS OK"), "cgrc": (CGRC, "CGRC OK")}[case]
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert ok in proc.stdout
