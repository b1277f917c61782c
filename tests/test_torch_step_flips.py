"""The rule that holds ``chip_smoke.py``'s synced card-vs-CPU steps (CCFCRec,
VBPR) element by element: ``synced_step_gap`` on crafted weights, the
float32-against-float64 test (``unsigned``) on one tiny VBPR step whose
state makes one gradient element cancel to rounding, and the synced route
of both models rehearsed on the CPU."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from coldrec_tpu_torch.config import default_args
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.models import TRAINERS
from coldrec_tpu_torch.runtime.checkpoints import save_embeddings
from coldrec_tpu_torch.runtime.trainer import Config
from test_torch_imports import _run_blocked
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

LR = 0.05
SHAPE = (400, 500)  # 200,000 elements: STEP_FLIPS lets 2 a step be excused
SMALL = (416, 64)  # VBPR's W: 26,624 elements, 1 (STEP_FLIPS rounded up)
SPOTS = ((3, 7), (100, 25), (399, 0))


def crafted(case, shape=SHAPE):
    """(card weights, CPU weights, start, grads) for ``case``: an Adagrad
    step from N(0, 0.1) weights on gradients of N(0, 1) (each element moved
    by -lr * sign(g)), the card's copy altered as the case says."""
    gen = torch.Generator().manual_seed(0)
    start = torch.randn(shape, generator=gen) * 0.1
    g32 = torch.randn(shape, generator=gen)
    g64 = g32.double()
    cpu = start - LR * g32.sign()
    card = cpu.clone()
    spots = {"too_many_unsigned": SPOTS, "two_unsigned": SPOTS[:2]}.get(
        case, SPOTS[:1])
    if "unsigned" in case:  # float32 gets its sign wrong: g64 ~ 0
        for i in spots:
            g64[i], g32[i] = 1e-12, 5e-11
    move = {"agree": 0.0, "drift": 0.0, "unsigned_too_far": 3 * LR}.get(
        case, 2 * LR)
    for i in spots:
        card[i] = cpu[i] - move
    if case == "drift":
        card = cpu * (1 + 2 * cs.COLD_NORM_RTOL)
    return {"W": card}, {"W": cpu}, {"W": start}, ({"W": g32}, {"W": g64})


@pytest.mark.parametrize("case, shape, holds, excused", [
    ("agree", SHAPE, True, 0),
    ("one_unsigned", SHAPE, True, 1),
    ("one_unsigned", SMALL, True, 1),
    ("one_signed", SHAPE, False, 0),
    ("too_many_unsigned", SHAPE, False, 3),
    ("two_unsigned", SMALL, False, 2),
    ("drift", SHAPE, False, 0),
    ("unsigned_too_far", SHAPE, False, 1),
])
def test_synced_step_rule(case, shape, holds, excused):
    """Pass or fail of crafted steps: every element agreeing, one element
    float32 cannot sign parting by 2 lr (named; in a weight of 200,000
    elements and in one of VBPR's W's 26,624), one it can parting by 2 lr,
    more unsigned elements than STEP_FLIPS allows (rounded up), a uniform
    drift over COLD_NORM_RTOL, an excused element parting by more than 2
    lr."""
    got, ref, start, grads = crafted(case, shape)
    calls = []

    def read():
        calls.append(1)
        return grads

    r = cs.synced_step_gap(got, ref, start, {"W": LR}, read)
    assert (not r["faults"]) == holds, r["faults"]
    assert r["excused"] == excused
    assert len(calls) == (0 if case == "agree" else 1)  # only when needed
    if case == "one_unsigned":
        (e,) = r["named"]
        assert (e["weight"], e["index"], e["excused"]) == ("W", SPOTS[0],
                                                           True)
        assert e["g64"] == 1e-12 and e["g32"] == pytest.approx(5e-11)
        assert e["cpu_update"] - e["card_update"] == pytest.approx(2 * LR)
        assert r["gap"] == 0.0 and r["old"] > cs.COLD_NORM_RTOL


def vbpr_trainer(tmp_path, data, d=8):
    """A VBPR trainer on the CPU over ``data``, its bus random MF tables."""
    rng = np.random.default_rng(1)
    save_embeddings(str(tmp_path), "synth", "item", "MF", {
        "user_emb": rng.standard_normal((data.user_num, d), np.float32),
        "item_emb": rng.standard_normal((data.item_num, d), np.float32)})
    return TRAINERS["VBPR"](Config(default_args(
        model="VBPR", dataset="synth", cold_object="item", emb_size=d,
        bs=64, seed=0, save_emb=False, emb_dir=str(tmp_path),
        device="cpu"), data))


def test_vbpr_step_marks_the_cancelled_element(tmp_path):
    """User u's rows P[u] and PQ2[u] are 0, so both of its pairs score 0 and
    softplus' slope is 1/2 on each; at column k its items' Q give the
    terms -1/2 * 1, +1/2 * 1 (pair (a, c)) and -1/2 * 0, +1/2 * 1e-8 (pair
    (b, e)): P[u, k]'s gradient is 5e-9 exactly, 0 in float32. Float32
    against float64 from that state marks that element and no other."""
    data, _ = synthetic_dataset(n_users=40, n_items=48, n_inter=600,
                                content_dim=12, seed=3)
    t = vbpr_trainer(tmp_path, data)
    u, k, (a, b, c, e) = 5, 2, (0, 1, 2, 3)
    m = t.model
    with torch.no_grad():
        m.P[u] = 0.0
        m.PQ2[u] = 0.0
        for i, v in ((a, 1.0), (c, 1.0), (b, 0.0), (e, 1e-8)):
            m.Q[i, k] = v
    rng = np.random.default_rng(4)
    others = rng.choice(np.setdiff1d(np.arange(data.user_num), [u]), 6,
                        replace=False)
    items = rng.choice(np.arange(4, data.item_num), (6, 2), replace=False)
    batch = {"user": np.r_[u, u, others],
             "pos_item": np.r_[a, b, items[:, 0]],
             "neg_item": np.r_[c, e, items[:, 1]],
             "weight": np.ones(8, np.float32)}
    state = {key: v.clone() for key, v in m.state_dict().items()}
    g32 = cs.step_grads(t, state, batch, {})
    cs.as_float64(t)
    g64 = cs.step_grads(t, state, batch, {})
    assert float(g32["P"][u, k]) == 0.0
    assert float(g64["P"][u, k]) == pytest.approx(0.5 * np.float32(1e-8))
    marked = {name: cs.unsigned(g32[name], g64[name]).nonzero().tolist()
              for name in g32}
    assert marked == {"P": [[u, k]], "Q": [], "PQ2": [], "W": []}


def test_synced_steps_rehearse_on_cpu_without_jax(tmp_path):
    """``hold_cold_steps`` (``cold_step_parity``, synced, and its float64
    free run) of VBPR and CCFCRec on phase train's split and MF bus at a
    tiny size, the CPU on both sides, in a process where importing jax or
    coldrec_tpu fails: every step holds, no element excused."""
    code = (
        "import tempfile\n"
        "import chip_smoke as cs\n"
        "for m in ('jax', 'coldrec_tpu'):\n"
        "    assert sys.modules[m] is None\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    cs.train_run('cpu', 300, 2000, 8000, d=16, bs=256, root=root,\n"
        "                 content_dim=12)\n"
        "    data = cs.read_split(root, 'bx_synth')\n"
        "    for model in ('VBPR', 'CCFCRec'):\n"
        "        steps = cs.hold_cold_steps('cpu', data, root, model, 16,\n"
        "                                   256, 3, 0)\n"
        "        assert len(steps) == 3, steps\n"
        "        assert all(not r['faults'] and r['excused'] == 0\n"
        "                   for r in steps), steps\n"
        "print('SYNCED OK')\n"
    )
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SYNCED OK" in proc.stdout
    for model in ("VBPR", "CCFCRec"):
        assert f"{model}: 3 steps cpu vs cpu" in proc.stdout, model
    assert proc.stdout.count(
        "in 0 of 3 steps (float64 gradients 0.00 s), 0 excused") == 2
