"""Extract + reduce Pareto parameter sets from stored BO trials (the port's
counterpart of the root bo_postprocess_parameters.py):

    python -m tum_control_tpu_torch.bo_postprocess_parameters TRIALS_CSV
        [--out data/F_new.csv] [--per-group 13] [--max-lat M]
        [--plot fronts.png] [--surrogate-plot STEM] [--device cuda|cpu]

The surrogate diagnostics fit their GPs on `--device` (cuda by default:
without a card the run raises unless `--device cpu` is given); the plots
need matplotlib.
"""
import argparse

import numpy as np

from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.eval.plots import pyplot
from tum_control_tpu_torch.learn.bo.diagnostics import surrogate_slice_plot
from tum_control_tpu_torch.learn.bo.optimizer import BayesianOptimizer, BOConfig
from tum_control_tpu_torch.learn.bo.postprocess import export_parameter_sets, extract_pareto


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trials_csv")
    ap.add_argument("--out", default="data/F_new.csv")
    ap.add_argument("--per-group", type=int, default=13)
    ap.add_argument("--max-lat", type=float, default=None,
                    help="exclude Pareto points whose worst segment "
                    "|lat_dev| exceeds this margin (catalog risk control)")
    ap.add_argument("--plot", default=None)
    ap.add_argument(
        "--surrogate-plot",
        default=None,
        metavar="STEM",
        help="save GP surrogate slice figures to STEM_g0.png / STEM_g1.png "
        "(reference helpers.py surrogate visualizer parity)",
    )
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


def plot_fronts(trials, path):
    """Each segment group's feasible trials and Pareto front."""
    plt = pyplot()
    fig, axs = plt.subplots(1, 2, figsize=(11, 5))
    for g, ax in enumerate(axs):
        Y_all = np.asarray([t.objectives[g] for t in trials
                            if np.asarray(t.feasible).reshape(-1)[g]])
        _, Yp = extract_pareto(trials, g)
        if len(Y_all):
            ax.scatter(Y_all[:, 0], Y_all[:, 1], s=8, alpha=0.4, label="trials")
        if len(Yp):
            o = np.argsort(Yp[:, 0])
            ax.plot(Yp[o, 0], Yp[o, 1], "r.-", label="Pareto front")
        ax.set_title(f"segment group {g}")
        ax.set_xlabel("-max |lat_dev| [m]")
        ax.set_ylabel("-RMS vel_dev [m/s]")
        ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.plot or args.surrogate_plot:
        pyplot()  # without matplotlib, raise before the export
    bo = BayesianOptimizer(evaluators=[], cfg=BOConfig(), device=device)
    bo.load_trials(args.trials_csv)
    n_feas = sum(bool(np.asarray(t.feasible).any()) for t in bo.trials)
    print(f"loaded {len(bo.trials)} trials ({n_feas} any-group feasible)")

    table = export_parameter_sets(
        bo.trials, args.out, n_per_group=args.per_group, per_group_files=True,
        max_lat=args.max_lat,
    )
    print(f"exported {len(table)} parameter sets to {args.out} (+ per-group _0/_1)")

    if args.plot:
        plot_fronts(bo.trials, args.plot)
        print(f"front plot -> {args.plot}")

    if args.surrogate_plot:
        for g in (0, 1):
            out = f"{args.surrogate_plot}_g{g}.png"
            try:
                surrogate_slice_plot(bo, g, out)
                print(f"surrogate slices group {g} -> {out}")
            except ValueError as exc:
                print(f"surrogate slices group {g} skipped: {exc}")
    return table


if __name__ == "__main__":
    main()
