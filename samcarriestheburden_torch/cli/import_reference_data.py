"""One-command importer for the reference repo's data conventions (JAX
``cli/import_reference_data.py``).

The real GrazPedWri-DX pipeline needs three pure-data assets that ship with
the reference checkout but are not re-distributed here (SURVEY §2 #33):

* ``data/500unlabeled_sample.csv``            — the fixed 500-image unlabelled
  refinement split (reference scripts/save_segmentations.py:25-28)
* ``data/successively_training_files_order.csv`` — the deterministic training
  subset order (reference scripts/seg_grazpedwri_dataset.py:77-84)
* ``data/cvat_annotation_xml/annotations_{train1,train2,val,test}.xml`` — the
  radiologists' CVAT annotations of the 64 labelled images

This CLI copies them from a reference checkout into a data root and validates
the schemas, so the real pipeline runs without hand-copying:

    python -m samcarriestheburden_torch.cli.import_reference_data \\
        --reference_root /path/to/SamCarriesTheBurden --data_root data

(The GrazPedWri-DX *images* are licensed separately — obtain them from the
dataset authors and prepare ``img_only_front_all_left/`` + ``dataset.csv``
with ``cli.copy_and_process_imgs``.)
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

XML_SPLITS = ("train1", "train2", "val", "test")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Copy the reference repo's split CSVs + CVAT XMLs into a "
                    "data root")
    p.add_argument("--reference_root", type=str, required=True,
                   help="path to a SamCarriesTheBurden checkout")
    p.add_argument("--data_root", type=str, default="data")
    args = p.parse_args(argv)

    import pandas as pd

    src = Path(args.reference_root) / "data"
    dst = Path(args.data_root)
    dst.mkdir(parents=True, exist_ok=True)

    csv_500 = src / "500unlabeled_sample.csv"
    df = pd.read_csv(csv_500)
    assert "filestem" in df.columns, f"{csv_500}: missing 'filestem' column"
    assert len(df) == 500, f"{csv_500}: expected 500 rows, got {len(df)}"
    shutil.copy2(csv_500, dst / csv_500.name)

    csv_order = src / "successively_training_files_order.csv"
    df = pd.read_csv(csv_order)
    assert "file_stem" in df.columns, f"{csv_order}: missing 'file_stem' column"
    shutil.copy2(csv_order, dst / csv_order.name)

    xml_dst = dst / "cvat_annotation_xml"
    xml_dst.mkdir(exist_ok=True)
    n_images = 0
    for split in XML_SPLITS:
        xml = src / "cvat_annotation_xml" / f"annotations_{split}.xml"
        assert xml.exists(), f"missing {xml}"
        # schema check with the same parser the datasets use
        from samcarriestheburden_torch.data.cvat import CVATParser

        parser = CVATParser([xml], True, False, True)
        n = len(parser.available_file_names)
        assert n > 0, f"{xml}: no annotated images found"
        n_images += n
        shutil.copy2(xml, xml_dst / xml.name)

    print(f"imported 2 split CSVs + {len(XML_SPLITS)} CVAT XMLs "
          f"({n_images} annotated images) into {dst}")
    print("next: prepare images with cli.copy_and_process_imgs "
          "(GrazPedWri-DX PNGs licensed separately)")
    return dst


if __name__ == "__main__":
    main()
