"""Inspect tuned params saved by the search driver (the port's copy of the
root ``param/view_best.py``; reference: param/view_best.py).

    python -m coldrec_tpu_torch.param.view_best --model M --dataset D \
        [--cold_object item] [--backbone MF]

Reads ``./param/<model>_<ds>_<obj>_bb_<backbone>_cs.pkl`` (written by
``python -m coldrec_tpu_torch.param_search`` or by the JAX driver) and
prints the same text as the JAX script.
"""
import argparse
import json
import os
import pickle


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--cold_object", default="item")
    p.add_argument("--backbone", default="MF")
    a = p.parse_args(argv)
    path = f"./param/{a.model}_{a.dataset}_{a.cold_object}_bb_{a.backbone}_cs.pkl"
    with open(path, "rb") as f:
        best = pickle.load(f)
    print(f"Best params from {path}:")
    # the pkl is the BARE params dict (reference contract); older runs of
    # the JAX framework wrapped it as {"best_params": ..., "best_value": ...}
    for k, v in best.get("best_params", best).items() if isinstance(best, dict) else []:
        print(f"  {k}: {v}")
    if isinstance(best, dict) and "best_value" in best:
        print(f"  (objective value: {best['best_value']})")
    else:
        sidecar = path[:-4] + ".value.json"
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                v = json.load(f)["best_value"]
            print(f"  (objective value: {v})")


if __name__ == "__main__":
    main()
