"""HPO result visualisation (JAX ``hpo/visualize.py``, reference
seg_processing/hpo_results/visualize_results.py): per-parameter slice plots
and the optimisation history from a saved study JSON.  ``matplotlib`` is
imported inside :func:`visualize_study`.

    python -m samcarriestheburden_torch.hpo.visualize --study <json> --save_dir <dir>
"""

from __future__ import annotations

from pathlib import Path

from samcarriestheburden_torch.hpo.study import Study


def visualize_study(study_path, save_dir=None, show: bool = False):
    from matplotlib import pyplot as plt

    study = Study.load(study_path)
    complete = [t for t in study.trials if t.state == "complete"]
    if not complete:
        raise ValueError("study has no completed trials")

    # optimisation history
    fig, ax = plt.subplots()
    ax.plot([t.number for t in complete], [t.value for t in complete], ".")
    best = study.best_trial
    ax.axhline(best.value, color="tab:green", ls="--",
               label=f"best {best.value:.4f}")
    ax.set_xlabel("trial")
    ax.set_ylabel("objective")
    ax.set_title(study.study_name)
    ax.legend()
    figs = {"history": fig}

    # per-parameter slices
    param_names = sorted({k for t in complete for k in t.params})
    for name in param_names:
        fig, ax = plt.subplots()
        xs = [t.params.get(name) for t in complete if name in t.params]
        ys = [t.value for t in complete if name in t.params]
        xs_plot = [str(x) for x in xs] if any(isinstance(x, str) or x is None
                                              for x in xs) else xs
        ax.plot(xs_plot, ys, ".")
        ax.set_xlabel(name)
        ax.set_ylabel("objective")
        figs[f"slice_{name}"] = fig

    if save_dir is not None:
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        for key, fig in figs.items():
            fig.savefig(save_dir / f"{key}.png", dpi=120)
            plt.close(fig)
    if show:
        plt.show()
    return figs


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--study", required=True)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--show", action="store_true")
    a = p.parse_args()
    visualize_study(a.study, a.save_dir, a.show)
