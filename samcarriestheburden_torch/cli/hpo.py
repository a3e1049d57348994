"""The command line of the three refinement HPO studies (JAX ``cli/hpo.py``, reference
seg_processing/*.py).

python -m samcarriestheburden_torch.cli.hpo --study sam_refine --model_id <id> [--cpu]

Runs on the card unless ``--cpu`` is given (raises without one).  Writes the
JAX CLI's files: ``<out_dir>/hpo_seg_preprocess.json``,
``grid_search_sam_refine.json`` or ``hpo_rnd_wlk_refine.json``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

OUTPUT_NAMES = {"preprocess": "hpo_seg_preprocess.json",
                "sam_refine": "grid_search_sam_refine.json",
                "rndwalk": "hpo_rnd_wlk_refine.json"}


def main(argv=None):
    p = argparse.ArgumentParser(description="Refinement HPO studies")
    p.add_argument("--study", required=True, choices=["preprocess", "sam_refine", "rndwalk"])
    p.add_argument("--model_id", type=str, required=True,
                   help="registry id of the initial U-Net")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--n_trials", type=float, default=float("inf"),
                   help="inf = full grid for grid studies, 200 otherwise")
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--cpu", action="store_true", help="run on the CPU; default: the card")
    args = p.parse_args(argv)

    from samcarriestheburden_torch.cli.common import setup_backend
    from samcarriestheburden_torch.hpo import objectives

    device = setup_backend(args)
    make_study = {"preprocess": objectives.build_preprocess_study,
                  "sam_refine": objectives.build_sam_refine_study,
                  "rndwalk": objectives.build_rndwalk_study}[args.study]
    objective, study = make_study(args.model_id, args.data_root, device=device)
    catch = (ValueError,) if args.study == "rndwalk" else ()  # reference :62
    study.optimize(objective, n_trials=args.n_trials, catch=catch, show_progress=True)
    print(study.best_params, study.best_value)

    out_dir = Path(args.out_dir or f"seg_processing/hpo_results/{args.model_id}")
    path = study.save(out_dir / OUTPUT_NAMES[args.study])
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
