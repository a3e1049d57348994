"""CPU tests of the benchmark: the harness at a tiny size against the port's
plain kernel versions.  Card-only tests carry the ``chip`` marker and skip
themselves where no CUDA device is present; run them on the card with

    python3 -m pytest benchmark/tests -q -m chip -p no:cacheprovider
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import torch  # noqa: E402

torch.set_num_threads(2)

TINY_SAM = dict(encoder_embed_dim=32, encoder_depth=2, encoder_num_heads=2,
                encoder_global_attn_indexes=[1], window_size=5, image_size=128,
                prompt_embed_dim=16, transformer_mlp_dim=32, transformer_num_heads=2,
                iou_head_hidden_dim=16, mask_in_chans=4)


def tiny(config: dict, traffic: dict) -> None:
    """Shrink a cell's configuration and mix in place to a CPU test's size:
    the same structure (windowed and global blocks with ragged windows, the
    17-class decode, the U-Net's four levels) at toy widths, with every
    sampled answer inside the first batches."""
    driver = traffic["driver"]
    if driver in ("precompute", "refine"):
        config.update(TINY_SAM)
        config["unet"].update(base_channels=4, n_last_channel=4, grid_hw=[48, 32])
        traffic.update(batch_size=2, pool=4, warmup_batches=1, check_within_batches=2)
        if driver == "precompute":
            traffic.update(image_hw=[160, 80], check_images=4)
        else:
            traffic.update(original_hw=[96, 64], check_batches=2)
    else:
        config.update(base_channels=4, n_last_channel=4, grid_hw=[48, 32], train_samples=40,
                      batch_size=4)
        traffic.update(draw_chunk=16)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (runs on the card only)")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided in the test, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
