"""Copy GrazPedWri frontal images, flipping right hands to left
(JAX ``cli/copy_and_process_imgs.py``, reference scripts/copy_and_process_imgs.py).

python -m samcarriestheburden_torch.cli.copy_and_process_imgs --src <GRAZPEDWRI img8bit dir>
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--src", type=str, required=True,
                   help="GRAZPEDWRI-DX img8bit directory")
    p.add_argument("--dst", type=str, default="data/img_only_front_all_left")
    p.add_argument("--data_root", type=str, default="data")
    args = p.parse_args(argv)

    import cv2
    import pandas as pd
    from tqdm import tqdm

    src_path = Path(args.src)
    dst_path = Path(args.dst)
    dst_path.mkdir(parents=True, exist_ok=True)
    df_meta = pd.read_csv(Path(args.data_root) / "dataset.csv", index_col="filestem")
    available = df_meta.index[df_meta["projection"] == 1].tolist()

    for name in tqdm(available, unit="img"):
        src = (src_path / name).with_suffix(".png")
        assert src.exists(), f"Image {name} not found in GrazPedWri dataset"
        if df_meta.loc[name, "laterality"] == "R":
            img = cv2.imread(str(src), cv2.IMREAD_GRAYSCALE)
            img = cv2.flip(img, 1)
            assert cv2.imwrite(str((dst_path / name).with_suffix(".png")), img), \
                f"Failed to write image {name}"
        else:
            shutil.copy(src, (dst_path / name).with_suffix(".png"))


if __name__ == "__main__":
    main()
