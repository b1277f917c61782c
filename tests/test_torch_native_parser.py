"""The port's CSV parser and permutation (``csrc/host_sampler.cpp`` through
``coldrec_tpu_torch/native.py``) against the JAX package's native library,
on the CPU.

Held bit for bit (values and dtype) on every case: the port's
``parse_interactions_native`` and ``load_interaction_csv`` against the JAX
package's ``native.parse_interactions_native`` and
``data.loader.load_interaction_csv`` (the cases of
``tests/test_native.py`` plus CRLF, blank lines, a header alone, an empty
file, extra columns, signs and dots in ids, an unterminated one-field line
and a file of 10^5 rows); ``count_csv_rows`` against the JAX library's;
``permutation_native`` against the JAX one for several sizes and seeds.
The port's loader never calls ``np.loadtxt``, and a missing file raises.
"""
import numpy as np
import pytest

from coldrec_tpu import native as jnative
from coldrec_tpu.data import loader as jloader
from coldrec_tpu_torch import native
from coldrec_tpu_torch.data import loader
from test_torch_threads import torch_threads  # noqa: F401

CASES = {
    "plain": "user,item\n3,7\n12,0\n5,999\n",
    "no_trailing_newline": "user,item\n1,2\n3,4",
    "extra_columns": "user,item,rating\n1,2,5\n3,4,1\n",
    "crlf": "user,item\r\n3,7\r\n12,0\r\n",
    "blank_lines": "user,item\n\n3,7\n\n\n12,0\n\n",
    "header_only": "user,item\n",
    "header_no_newline": "user,item",
    "empty": "",
    "many_extra_columns": "u,i,r,t\n1,2,3,4\n5,6,7,8\n9,10\n",
    "signs_and_dots": "user,item\n-3,7\n1.5,2\n+4,0.0\n",
    "one_field_last_line": "user,item\n1,2\n3",
    "one_field_lines": "user,item\n7\n1,2\n8\n",
}


def _large(seed=0, rows=100_000) -> str:
    rng = np.random.default_rng(seed)
    pairs = np.stack([rng.integers(0, 92_107, rows),
                      rng.integers(0, 270_170, rows)], axis=1)
    return "user,item\n" + "\n".join(f"{u},{i}" for u, i in pairs) + "\n"


def _jax_count(path) -> int:
    lib = jnative._load()
    assert lib is not None, "the JAX package's native library did not load"
    return int(lib.count_csv_rows(str(path).encode()))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("csv")
    out = {}
    for name, text in {**CASES, "rows_1e5": _large()}.items():
        path = root / f"{name}.csv"
        path.write_bytes(text.encode())
        out[name] = str(path)
    return out


@pytest.mark.parametrize("name", [*CASES, "rows_1e5"])
def test_parser_matches_jax(files, name):
    path = files[name]
    got = native.parse_interactions_native(path)
    ref = jnative.parse_interactions_native(path)
    assert got.dtype == ref.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    assert native.count_csv_rows(path) == _jax_count(path)
    got = loader.load_interaction_csv(path)
    ref = jloader.load_interaction_csv(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if name == "rows_1e5":
        assert got.shape == (100_000, 2)


def test_loader_never_calls_loadtxt(files, monkeypatch):
    def refused(*a, **k):
        raise AssertionError("np.loadtxt called")

    monkeypatch.setattr(np, "loadtxt", refused)
    assert loader.load_interaction_csv(files["plain"]).tolist() == [
        [3, 7], [12, 0], [5, 999]]


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        loader.load_interaction_csv(str(tmp_path / "absent.csv"))


@pytest.mark.parametrize("n", [0, 1, 2, 17, 4096])
@pytest.mark.parametrize("seed", [0, 1, 2024, 2**63 + 5, -3])
def test_permutation_matches_jax(n, seed):
    got = native.permutation_native(n, seed)
    ref = jnative.permutation_native(n, seed)
    assert got.dtype == ref.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    assert sorted(got.tolist()) == list(range(n))
