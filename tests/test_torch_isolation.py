"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import ast
import json
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import samcarriestheburden_torch
from samcarriestheburden_torch.config import sam_vit_t_config
from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.kernels import build
from samcarriestheburden_torch.models.sam import build_sam

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "samcarriestheburden_torch"
CHIP_SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "samcarriestheburden_tpu")
#: what the card's machine may lack: imported only inside the functions that use it
HOST_ONLY = ("h5py", "cv2", "pandas", "tqdm", "PIL", "matplotlib", "orbax")
#: the pseudo-label pipeline's modules
PIPELINE_MODULES = ("cli", "cli.common", "cli.generate_img_embeddings", "cli.save_segmentations",
                    "cli.save_refined_segmentations", "cli.select_pseudo_labels", "data.cvat",
                    "models.unet", "models.modelio", "models.build", "profiling")
#: U-Net training's modules, the training and data CLIs among them
TRAINING_MODULES = ("train", "train.augment", "train.loop", "train.checkpoint", "train.logging",
                    "data.datasets", "cli.train", "cli.train_on_pseudo_labels",
                    "cli.make_synthetic_dataset", "cli.define_successively_data_subsets",
                    "cli.copy_and_process_imgs", "cli.import_reference_data",
                    "cli.sanity_check_saved_segmentation")
#: the random walk and HPO, the predictor and AMG (queue A items 3 and 4)
RNDWALK_AMG_MODULES = ("ops.random_walk", "ops.seg_preprocessing", "hpo", "hpo.study",
                       "hpo.objectives", "hpo.visualize", "cli.hpo", "ops.mask_ops",
                       "ops.resize", "ops.nms", "native", "ops.rle", "ops.regions",
                       "engine.predictor", "engine.amg", "cli.amg")
#: multi-process scale-out, the reference-layout shims and the version
PARALLEL_SHIM_MODULES = ("parallel", "parallel.distributed", "parallel.mesh", "parallel.worker",
                         "parallel._harness",
                         "parallel.dryrun", "utils", "utils.cvat_parser",
                         "utils.dice_coefficient", "utils.random_walk", "utils.seg_refinement",
                         "utils.segmentation_preprocessing", "version")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(samcarriestheburden_torch.__path__,
                                                        "samcarriestheburden_torch."))


def test_every_module_imports_without_jax():
    modules = _port_modules()
    for name in ("kernels.attention", "kernels.quant", "models.quantize", "kernels.cost_probe",
                 "bench", "tools.bench_int8pv", "tools.exp_attn", "tools.exp_attn2",
                 *PIPELINE_MODULES, *TRAINING_MODULES, *RNDWALK_AMG_MODULES,
                 *PARALLEL_SHIM_MODULES):
        assert f"samcarriestheburden_torch.{name}" in modules
    code = ("import sys\n"
            + "".join(f"sys.modules[{name!r}] = None\n" for name in FORBIDDEN)
            + "import importlib\n"
            + f"for name in {modules!r}:\n    importlib.import_module(name)\n"
            + "import chip_smoke\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_every_module_imports_without_h5py():
    """The card's machine has no h5py, and nothing promises cv2, pandas, tqdm,
    PIL, matplotlib or orbax there: the port imports each only inside the
    function that opens a file, plots or shows progress (``data/h5io.py``,
    ``data/datasets.py``, the CLIs, ``engine/embeddings.py:load_image_rgb``),
    never with a module; and ``chip_smoke.py`` drives the pipeline's loops
    and the trainer without them."""
    modules = _port_modules()
    for name in ("data.h5io", "engine.decoder_head", "engine.refinement", "kernels.ccl",
                 *PIPELINE_MODULES, *TRAINING_MODULES, *RNDWALK_AMG_MODULES,
                 *PARALLEL_SHIM_MODULES):
        assert f"samcarriestheburden_torch.{name}" in modules
    code = ("import sys\n"
            + "".join(f"sys.modules[{name!r}] = None\n" for name in HOST_ONLY)
            + "import importlib\n"
            + f"for name in {modules!r}:\n    importlib.import_module(name)\n"
            + "import chip_smoke\nchip_smoke.enhance_modules()\nchip_smoke.pipeline_modules()\n"
            + "chip_smoke.training_modules()\nchip_smoke.rndwalk_amg_modules()\n"
            + "chip_smoke.parallel_modules()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_amg_and_random_walk_pull_in_no_host_only_package():
    """Importing the AMG engine and the random walk loads none of cv2, pandas
    or matplotlib (the HPO objectives and the CLIs import them inside the
    functions that read files or plot)."""
    code = ("import sys\n"
            "import samcarriestheburden_torch.engine.amg, samcarriestheburden_torch.ops.random_walk\n"
            "import samcarriestheburden_torch.hpo.objectives, samcarriestheburden_torch.cli.hpo\n"
            "import samcarriestheburden_torch.cli.amg, samcarriestheburden_torch.hpo.visualize\n"
            "print(sorted(m for m in ('cv2', 'pandas', 'matplotlib') if m in sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_the_parametrized_scan_covers_the_int8_modules():
    """... and the port's bench and tools (their JAX originals, ``bench.py``
    and ``tools/``, import JAX)."""
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"kernels/quant.py", "models/quantize.py", "models/convert.py", "bench.py",
            "tools/bench_int8pv.py", "kernels/cost_probe.py", "tools/exp_attn.py",
            "tools/exp_attn2.py"} <= scanned
    # ... and the pipeline's modules, the CLIs among them
    assert {name.replace(".", "/") + ".py" for name in PIPELINE_MODULES
            if name != "cli"} <= scanned
    # ... and U-Net training's
    assert {name.replace(".", "/") + ".py" for name in TRAINING_MODULES
            if name != "train"} | {"train/__init__.py"} <= scanned
    # ... and the random walk's, HPO's, the predictor's and AMG's
    assert {name.replace(".", "/") + ".py" for name in RNDWALK_AMG_MODULES
            if name != "hpo"} | {"hpo/__init__.py"} <= scanned
    # ... and multi-process scale-out's, the shims and the version
    assert {name.replace(".", "/") + ".py" for name in PARALLEL_SHIM_MODULES
            if name not in ("parallel", "utils")} | {"parallel/__init__.py",
                                                      "utils/__init__.py"} <= scanned


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT))
                                        for p in (PORT / "kernels").glob("*.py")))
def test_kernels_build_only_inside_the_launching_function(path):
    """Importing a kernel module compiles nothing and needs no Triton: the
    library is built and loaded (``build.load``/``build.build``), and
    ``triton`` imported, only inside functions."""
    tree = ast.parse((ROOT / path).read_text())
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        for node in ast.walk(stmt):
            if isinstance(node, ast.Import):
                assert all(a.name.split(".")[0] != "triton" for a in node.names), path
            elif isinstance(node, ast.ImportFrom):
                assert (node.module or "").split(".")[0] != "triton", path
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                called = (getattr(node.func.value, "id", None), node.func.attr)
                assert called not in {("build", "load"), ("build", "build"),
                                      ("ctypes", "CDLL"), ("subprocess", "Popen"),
                                      ("subprocess", "run")}, f"{path}:{node.lineno}"


def test_cuda_sources_are_registered_and_stand_alone():
    """Every ``csrc/*.cu`` is built by ``kernels/build.py`` (the int8 kernels'
    ``quant.cu`` among them) with a plain C interface: CUDA's own headers and
    the port's ``common.cuh`` only, nothing of PyTorch or another framework."""
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert sources == sorted(build.SOURCES) and "quant" in sources
    allowed = {"common.cuh", "rel_attention.cuh", "global_attention.cuh",
               "window_attention.cuh", "hopper.cuh", "gemm_sm90.cuh", "cuda_bf16.h",
               "cuda_runtime.h", "cuda.h", "cooperative_groups.h",
               "stdint.h", "math.h", "type_traits"}
    for path in sorted(build.CSRC.glob("*.cu*")):
        text = path.read_text()
        includes = re.findall(r'#include\s+[<"]([^>"]+)[>"]', text)
        assert includes and set(includes) <= allowed, (path.name, includes)
        if path.suffix == ".cu":
            assert 'extern "C"' in text, path.name
    quant = (build.CSRC / "quant.cu").read_text()
    for symbol in ("k2_ln_masked_linear_int8", "k4_ln_mlp_residual_int8",
                   "k15_ln_mlp_residual_int8_exp", "gemm_sm90_mainloop"):
        assert symbol in quant
    gemm = (build.CSRC / "gemm.cu").read_text()
    assert "k14_dot" in gemm and "gemm_sm90_mainloop" in gemm
    # every GEMM (K1-K4, K14, K15) on the TMA + wgmma mainloop, bf16 at both
    # tile widths; the mma.sync mainloops (int8, then K1 and K3's bf16) are gone
    sm90 = (build.CSRC / "gemm_sm90.cuh").read_text()
    assert "wgmma.mma_async" in sm90 and "tma_load_2d" in sm90
    assert "m64n256k16.f32.bf16.bf16" in sm90 and "m64n128k16.f32.bf16.bf16" in sm90
    mlp = (build.CSRC / "mlp.cu").read_text()
    assert '#include "gemm_sm90.cuh"' in mlp and "gemm_sm90_mainloop" in mlp
    assert "gemm_bf16" not in mlp and "mma_bf16" not in mlp
    assert "gemm_s8_mainloop" not in (build.CSRC / "common.cuh").read_text()
    attention = (build.CSRC / "attention.cu").read_text()
    assert "k7_rel_attention_global_int8" in attention and "k7_rel_attention_global_pv" in attention
    # what the attention kernels share, with attention_forms.cu: the forms, the
    # operands, the pre-passes (vq in the key order of the p.v A fragments);
    # no attention kernel and no mma.sync product of its own
    rel = (build.CSRC / "rel_attention.cuh").read_text()
    assert "v_quant_kernel" in rel and "pv_key" in rel and "SM_PV" in rel
    assert "rel_attention_kernel" not in rel and "mma_s8" not in rel and "mma_bf16" not in rel
    for flag in ("SM_V1", "SM_V3", "SM_NOEXP", "REL_NONE", "REL_BASE0"):
        assert flag in rel
    forms = (build.CSRC / "attention_forms.cu").read_text()
    assert "k16_rel_attention_forms" in forms
    for text in (attention, forms):
        assert '#include "rel_attention.cuh"' in text
    assert "k13_cost_probe" in (build.CSRC / "cost_probe.cu").read_text()
    block = (build.CSRC / "block_attention.cu").read_text()
    assert "k12_window_block_attention" in block
    # K12: one thread-block cluster per window, every product on wgmma (the
    # window kernel's attention included), the heads summed by one product
    # over K = E through distributed shared memory: no mma.sync, no scratch
    # pass, no atomics
    assert "wgmma.mma_async" in block and '#include "window_attention.cuh"' in block
    assert "cudaLaunchAttributeClusterDimension" in block and "cudaLaunchKernelEx" in block
    assert "ld.shared::cluster" in block and "mapa.shared::cluster" in block
    for gone in ("mma_bf16", "round_kernel", "atomicAdd", "ldmatrix", "cp_async"):
        assert gone not in block, gone
    common = (build.CSRC / "common.cuh").read_text()
    # the int8 mma.sync product is gone with its last user, K7's int8 p.v pair
    assert "m16n8k32.row.col.s32.s8.s8.s32" not in common and "mma_s8" not in common
    # the bf16 mma.sync GEMM mainloop is gone with its last users, K1 and K3;
    # the m16n8k16 product stays for the global kernel's small rel-term
    # product alone (K12's products moved to wgmma)
    assert "gemm_bf16_mainloop" not in common and "namespace gemm_bf16" not in common
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in common
    users = sorted(p.name for p in build.CSRC.glob("*.cu*")
                   if p.name != "common.cuh" and "mma_bf16(" in p.read_text())
    assert users == ["global_attention.cuh"], users


def _c_function(text: str, name: str) -> str:
    """The body of the ``extern "C"`` function ``name`` in a source's text."""
    start = text.index(f'extern "C" int {name}(')
    return text[start:text.index("\n}\n", start)]


def test_the_global_instances_run_the_hopper_kernel():
    """K7, K7-int8, K7-pv, K7-int8pv, K9 on the global grid, K11 and K16's v1
    and v3 on the grid launch ``global_attention_kernel``
    (``csrc/global_attention.cuh``: TMA, mbarriers, wgmma for both products;
    K7's int8 p.v pair as its SM_PV form, p.v on s8 wgmma with P in
    registers); no ``mma.sync`` attention kernel is left."""
    header = (build.CSRC / "global_attention.cuh").read_text()
    assert '#include "hopper.cuh"' in header     # the mbarrier, TMA and wgmma helpers
    header += (build.CSRC / "hopper.cuh").read_text()
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier", "m64n64k32.s32.s8.s8",
                "m64n80k32.s32.s8.s8", "cuTensorMapEncodeTiled", "global_attention_kernel"):
        assert ptx in header, ptx
    attention = (build.CSRC / "attention.cu").read_text()
    forms = (build.CSRC / "attention_forms.cu").read_text()
    for text in (attention, forms):
        assert '#include "global_attention.cuh"' in text
    for name in ("k7_rel_attention_global", "k7_rel_attention_global_int8",
                 "k9_rel_attention_pre", "k11_rel_attention_headmajor_global"):
        body = _c_function(attention, name)
        assert "dispatch<8" not in body and "dispatch_global<" in body, name
    pv = _c_function(attention, "k7_rel_attention_global_pv")
    assert "dispatch_global<true, false, SM_PV>" in pv and "dispatch_global<false, false, SM_PV>" in pv
    # every __global__ of the attention sources is the global or the window
    # kernel, or a pre-pass of the int8 modes (column absmax, kq, vq)
    kernels = set()
    for name in ("rel_attention.cuh", "global_attention.cuh", "window_attention.cuh",
                 "attention.cu", "attention_forms.cu"):
        kernels.update(re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(",
                                  (build.CSRC / name).read_text()))
    assert kernels == {"global_attention_kernel", "window_attention_kernel", "k_absmax_kernel",
                       "k_quant_kernel", "v_quant_kernel"}, kernels
    assert "dispatch<8" not in forms and "dispatch_form<8" not in forms
    assert "dispatch_global_form<SM_V1>" in forms and "dispatch_global_form<SM_V3>" in forms
    assert "dispatch_global<" in forms


def test_the_window_instances_run_the_hopper_kernel():
    """K5, K6, K9 on a window, K10 and K16's window forms launch
    ``window_attention_kernel`` (``csrc/window_attention.cuh``: persistent
    blocks, TMA, mbarriers, one wgmma product of 208 key columns with the rel
    terms as the selector product); ``rel_attention.cuh`` keeps no attention
    kernel of its own: the mma.sync flash loop, with its window, rect,
    caller's-rel-terms and form paths, is gone (its last instances, K7's int8
    p.v pair, run on the global kernel)."""
    header = (build.CSRC / "window_attention.cuh").read_text()
    for ptx in ("wgmma.mma_async", "m64n208k16", "tma_load(", "mbar_wait(", "encode_map(",
                "window_attention_kernel", "persistent_grid"):
        assert ptx in header, ptx
    attention = (build.CSRC / "attention.cu").read_text()
    forms = (build.CSRC / "attention_forms.cu").read_text()
    for text in (attention, forms):
        assert '#include "window_attention.cuh"' in text
    for name in ("k5_rel_attention_window", "k6_rel_attention_window_rect",
                 "k9_rel_attention_pre", "k10_rel_attention_headmajor"):
        body = _c_function(attention, name)
        assert "dispatch_window<" in body and "dispatch<" not in body, name
    assert "dispatch_window<" in forms and "dispatch<" not in forms
    rel = (build.CSRC / "rel_attention.cuh").read_text()
    for path in build.CSRC.glob("*.cu*"):
        assert "rel_attention_kernel" not in path.read_text(), path.name
    # what is left between the forms and the operands is the pre-passes
    passes = rel[rel.index("__host__ __device__ constexpr int padded_hd"):
                 rel.index("struct Operands")]
    for gone in ("RECT", "PRE", "SM_V1", "SM_V3", "SM_NOEXP", "REL_BASE0", "qkv_bias",
                 "mma_", "mma.sync", "ldmatrix"):
        assert gone not in passes, gone


#: the C entry point of every counted kernel and the registered source that holds it
#: (and the Python module that binds it, where that is not the source's namesake)
ENTRY_POINTS = {"K1": ("mlp", "k1_"), "K2": ("quant", "k2_ln_masked_linear_int8"),
                "K3": ("mlp", "k3_"), "K4": ("quant", "k4_ln_mlp_residual_int8"),
                "K5": ("attention", "k5_rel_attention_window"),
                "K6": ("attention", "k6_rel_attention_window_rect"),
                "K7": ("attention", "k7_rel_attention_global"),
                "K7-int8": ("attention", "k7_rel_attention_global_int8"),
                "K8": ("ccl", "k8_"),
                "K9": ("attention", "k9_rel_attention_pre"),
                "K10": ("attention", "k10_rel_attention_headmajor"),
                "K11": ("attention", "k11_rel_attention_headmajor_global"),
                "K12": ("block_attention", "k12_window_block_attention", "attention"),
                "K7-pv": ("attention", "k7_rel_attention_global_pv"),
                "K7-int8pv": ("attention", "k7_rel_attention_global_pv"),
                "K13": ("cost_probe", "k13_cost_probe"),
                "K14": ("gemm", "k14_dot"),
                "K15": ("quant", "k15_ln_mlp_residual_int8_exp"),
                **{name: ("attention_forms", "k16_rel_attention_forms", "attention")
                   for name in ("K16-v1", "K16-v3", "K16-norel", "K16-noroll", "K16-noexp")}}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_every_counted_kernel_has_a_c_entry_point_in_a_registered_source(name):
    """``kernels.LAUNCHES`` counts exactly these kernels, and each one's
    ``extern "C"`` launch function stands in a source that ``build.SOURCES``
    builds and that its Python module binds (K6, the compact layout's edge
    windows, in ``attention.cu`` beside K5; K9-K11 and K7's int8 p.v there
    too, K12 in ``block_attention.cu``, bound by ``kernels/attention.py``;
    K13 in ``cost_probe.cu``)."""
    from samcarriestheburden_torch import kernels

    assert set(kernels.LAUNCHES) == set(ENTRY_POINTS)
    source, symbol, *module = ENTRY_POINTS[name]
    assert source in build.SOURCES
    text = (build.CSRC / f"{source}.cu").read_text()
    entries = re.findall(r'extern "C" int (\w+)\(', text)
    bound = [e for e in entries if e.startswith(symbol)]
    assert bound, (name, entries)
    binding = (PORT / "kernels" / f"{(module or [source])[0]}.py").read_text()
    assert f'build.load("{source}")' in binding
    assert all(f"lib.{e}" in binding or f".{e}(" in binding for e in bound), (name, bound)
    # K16's instances share one launch, counted under the name its form maps to
    assert f'LAUNCHES["{name}"] += 1' in binding or (
        f'"{name}")' in binding and "LAUNCHES[name] += 1" in binding), name


def test_the_int8_wrappers_never_reach_the_compiler_on_cpu(monkeypatch):
    """On CPU tensors K2, K4 and K7-int8 run their plain versions: the build
    is not touched (it would raise here: there is no ``nvcc``)."""
    from samcarriestheburden_torch.kernels import attention as attn_k
    from samcarriestheburden_torch.kernels import quant as quant_k

    def refuse(*a, **k):
        raise AssertionError("the CUDA build was reached for a CPU tensor")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)
    e, m = 32, 64
    x = torch.randn(8, e)
    wq, s = quant_k.quantize_weight(torch.randn(3 * e, e))
    w1q, s1 = quant_k.quantize_weight(torch.randn(m, e))
    w2q, s2 = quant_k.quantize_weight(torch.randn(e, m))
    ones, zeros = torch.ones(e), torch.zeros(e)
    qkv = quant_k.ln_masked_linear_int8(x[:4], None, ones, zeros, wq, s, torch.zeros(3 * e))
    out = quant_k.ln_mlp_residual_int8(x, ones, zeros, w1q, s1, torch.zeros(m), w2q, s2, zeros)
    att = attn_k.rel_attention_global(qkv.reshape(1, 4, 3 * e), torch.zeros(6, 16), kh=2, kw=2,
                                      heads=2, hd=16, int8_qk=True)
    assert torch.isfinite(out).all() and tuple(att.shape) == (1, 4, e)


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from samcarriestheburden_torch.cli import amg as amg_cli
    from samcarriestheburden_torch.cli import (generate_img_embeddings, hpo,
                                               save_refined_segmentations, save_segmentations,
                                               train, train_on_pseudo_labels)
    from samcarriestheburden_torch.engine.refinement import RndWalkSegRefiner
    from samcarriestheburden_torch.hpo import objectives
    from samcarriestheburden_torch.config import TrainConfig, UNetConfig
    from samcarriestheburden_torch.engine.embeddings import encode_images, precompute_embeddings
    from samcarriestheburden_torch.models.build import build_sam_vit_h, sam_model_registry
    from samcarriestheburden_torch.models.modelio import ModelRegistry
    from samcarriestheburden_torch.models.unet import build_unet
    from samcarriestheburden_torch.parallel.distributed import initialize
    from samcarriestheburden_torch.train.loop import UNetTrainer, train_unet

    registry = ModelRegistry(tmp_path / "model_registry")
    model_id = registry.register(UNetConfig(base_channels=4, n_last_channel=4), build_unet(
        UNetConfig(base_channels=4, n_last_channel=4), device="cpu", seed=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_sam(sam_vit_t_config(), seed=0)
    assert resolve_device("cpu").type == "cpu"
    for call in (build_sam_vit_h, sam_model_registry["vit_t"],
                 lambda: build_unet(UNetConfig(), seed=0),
                 lambda: registry.load(model_id),
                 lambda: encode_images(None, None, [], None, None, img_size=128, device=None),
                 lambda: precompute_embeddings(sam_model_registry["vit_t"](), [],
                                               tmp_path / "emb.h5", "none"),
                 lambda: generate_img_embeddings.main(["--model_type", "vit_t"]),
                 lambda: save_segmentations.main(["--model_id", model_id,
                                                  "--data_root", str(tmp_path)]),
                 lambda: save_refined_segmentations.main(["--model_id", model_id,
                                                          "--data_root", str(tmp_path)]),
                 lambda: UNetTrainer(UNetConfig(base_channels=4), TrainConfig()),
                 lambda: train_unet(None, None, UNetConfig(base_channels=4), TrainConfig()),
                 lambda: train.main(["--data_root", str(tmp_path)]),
                 lambda: train_on_pseudo_labels.main(["--pseudo_label", "raw", "--model_id",
                                                      model_id, "--data_root", str(tmp_path)]),
                 lambda: RndWalkSegRefiner(4, 10.0),
                 lambda: objectives.build_preprocess_study(model_id, str(tmp_path)),
                 lambda: objectives.build_sam_refine_study(model_id, str(tmp_path)),
                 lambda: objectives.build_rndwalk_study(model_id, str(tmp_path)),
                 lambda: hpo.main(["--study", "rndwalk", "--model_id", model_id,
                                   "--data_root", str(tmp_path)]),
                 lambda: amg_cli.main(["--input", str(tmp_path), "--output", str(tmp_path / "o"),
                                       "--model-type", "vit_t", "--checkpoint", "x.pth"]),
                 lambda: initialize("localhost:1", 1, 0, backend="gloo"),
                 lambda: initialize("localhost:1", 1, 0, backend="nccl")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert registry.load(model_id, device="cpu")[1].device.type == "cpu"


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    """Away from the repo (or without a card) the smoke test exits non-zero
    and prints no result line."""
    shutil.copy(CHIP_SMOKE, tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
