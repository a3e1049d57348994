"""Order training files so that index 0 has all 17 classes annotated
(JAX ``cli/define_successively_data_subsets.py``, reference
scripts/define_successively_data_subsets.py:9-36).

The reference selects the first file by manual visual inspection (index 13);
here ``--selected_index`` defaults to the first file with all classes present
and can be overridden after inspection with ``--show``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--selected_index", type=int, default=None,
                   help="index of the file to put first (default: first with all classes)")
    p.add_argument("--show", action="store_true", help="plot candidates")
    args = p.parse_args(argv)

    import pandas as pd

    from samcarriestheburden_torch.data.datasets import LightSegGrazPedWriDataset

    ds = LightSegGrazPedWriDataset("train", data_root=args.data_root)
    files = ds.available_file_names
    seg_sum = np.stack([ds.data[f]["mask"].sum((-2, -1)) for f in files])
    all_present = seg_sum.all(1)

    candidates = np.flatnonzero(all_present)
    assert len(candidates) > 0, "no training file has all classes annotated"
    if args.show:
        from matplotlib import pyplot as plt

        for idx in candidates:
            f = files[idx]
            img = ds.data[f]["image"][0]
            mask = ds.data[f]["mask"]
            fig, axs = plt.subplots(1, 2)
            fig.suptitle(f)
            axs[0].imshow(img, "gray")
            axs[1].imshow(img, "gray")
            axs[1].imshow(mask.argmax(0), alpha=mask.any(0).astype(float))
        plt.show()

    selected = args.selected_index if args.selected_index is not None \
        else int(candidates[0])
    print("selected file:", files[selected])

    ordered = list(files)
    del ordered[selected]
    ordered.insert(0, files[selected])
    series = pd.Series(data=ordered, name="file_stem")
    assert series.is_unique, "files are not unique"
    assert len(series) == len(ds), "files are missing or duplicated"
    out = Path(args.data_root) / "successively_training_files_order.csv"
    series.to_csv(out, header=True)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
