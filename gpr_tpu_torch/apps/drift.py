"""Drift analysis: retrain on sliding training windows, compare error
percentiles across windows.

Mirrors gpr_tpu/apps/drift.py:1-117 (``run_drift``, ``main``), the
reference's drift study (reference scripts/drift_analysis.sh:42-50, a bash
loop rewriting ``start_trainInd`` / ``n_trainImgs`` and re-running the
pipeline, plus scripts/validation_drift.py:31-77).  The window loop runs in
process: per window the port's ``learn`` and ``predict`` apps on ``device``
(the card unless given ``device="cpu"``) and ``validate.dvf_error``; the
result is one JSON of percentile statistics per window.

    python -m gpr_tpu_torch.apps.drift <config.yaml> <n_train> <start0,start1,...>

The YAML is read only by :func:`run_drift` and :func:`main`;
:func:`run_drift_config` takes the parsed configuration and the study's root,
so a caller without PyYAML can run the study.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional, Sequence

from ..utils.profiling import StageTimer


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def run_drift_config(cfg: dict, root: str, n_train: int, starts: Sequence[int], device=None,
                     timer: Optional[StageTimer] = None) -> Dict[str, Dict]:
    """The windows of ``cfg`` (drift.py:34-87) under ``root``; ``timer``, when
    given, records each window's learn, predict and validate stages."""
    from . import learn, predict, validate

    timer = StageTimer() if timer is None else timer
    general = cfg.get("general", {})
    reg_dir = os.path.join(root, general.get("registration_dir", "reg3d"))
    surrogate_dir = os.path.join(root, general.get("surrogate_dir", "us"))
    subdir = cfg.get("gpr_model", {}).get("subdir", "test")
    master = os.path.join(root, general.get("master_volume", ""))

    results: Dict[str, Dict] = {}
    for start in starts:
        tag = f"win{start:04d}"
        gpr_dir = os.path.join(reg_dir, f"gpr_{tag}")
        result_dir = os.path.join(reg_dir, f"{subdir}_pred_{tag}")
        os.makedirs(gpr_dir, exist_ok=True)
        os.makedirs(result_dir, exist_ok=True)

        cfg_learn = dict(cfg.get("gpr_learn", {}), n_trainImgs=n_train, start_trainInd=start)
        cm = os.path.join(gpr_dir, "config_model.json")
        cl = os.path.join(gpr_dir, "config_learn.json")
        cp = os.path.join(gpr_dir, "config_predict.json")
        _write_json(cm, cfg.get("gpr_model", {}))
        _write_json(cl, cfg_learn)
        _write_json(cp, cfg.get("gpr_predict", {}))

        prefix = os.path.join(gpr_dir, "gpr")
        with timer.stage(f"{tag} learn"):
            rc = learn.main(
                [cm, cl, prefix, os.path.join(surrogate_dir, "train"),
                 os.path.join(reg_dir, "train"),
                 os.path.join(root, general.get("ar_dir", "ar"))],
                device=device,
            )
        if rc != 0:
            raise RuntimeError(f"drift window {start}: learn failed ({rc})")
        with timer.stage(f"{tag} predict"):
            rc = predict.main(
                [cm, cp, prefix, os.path.join(surrogate_dir, subdir),
                 os.path.join(reg_dir, subdir), result_dir, master],
                device=device,
            )
        if rc != 0:
            raise RuntimeError(f"drift window {start}: predict failed ({rc})")

        with timer.stage(f"{tag} validate"):
            stats = validate.dvf_error(os.path.join(reg_dir, subdir), result_dir)
        results[tag] = {
            "start": start,
            "n_train": n_train,
            "percentiles": {str(k): v for k, v in stats["percentiles"].items()},
            "median_per_frame": stats["median_per_frame"].tolist(),
        }
    return results


def _load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def run_drift(config_path: str, n_train: int, starts: Sequence[int], device=None) -> Dict[str, Dict]:
    """drift.py:23-87: the study of a YAML file, its root the config's
    ``root_dir`` or, without one, the config's folder."""
    cfg = _load_yaml(config_path)
    root = cfg.get("general", {}).get("root_dir", os.path.dirname(os.path.abspath(config_path)))
    return run_drift_config(cfg, root, n_train, starts, device=device)


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print("Usage: drift <config.yaml> <n_trainImgs> <start0,start1,...>")
        return -1
    config_path = argv[0]
    n_train = int(argv[1])
    starts = [int(s) for s in argv[2].split(",")]
    results = run_drift(config_path, n_train, starts, device=device)
    # write into the study's root_dir (not next to the config: configs ship
    # in the repo and run output must not dirty the working tree)
    _cfg = _load_yaml(config_path)
    _root = _cfg.get("general", {}).get("root_dir", os.path.dirname(os.path.abspath(config_path)))
    # a relative root_dir is relative to the config, not the CWD (the
    # reference resolves paths against the yaml's location too), and the
    # study dir may not exist yet on a fresh run
    if not os.path.isabs(_root):
        _root = os.path.join(os.path.dirname(os.path.abspath(config_path)), _root)
    os.makedirs(_root, exist_ok=True)
    out = os.path.join(_root, "drift.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    for tag, r in results.items():
        p = r["percentiles"]
        print(f"{tag}: 50%={p['50']:.4f} 95%={p['95']:.4f} 99%={p['99']:.4f}")
    print(f"written: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
