"""Export the prompt encoder and mask decoder for deployment (JAX
``cli/export_decoder.py``; reference scripts/export_onnx_model.py).

Two formats:

* ``--format torch_export`` (default) writes a ``torch.export`` artifact
  (``.pt2``) with symbolic batch and point axes unless ``--batch`` or
  ``--num-points`` fix them, and optional bf16 or int8 weights
  (``export/program.py``).  The artifact is bound to the device it was
  exported on: the card, or the CPU under ``--cpu``.
* ``--format onnx`` writes an opset-17 ``.onnx`` graph with the reference's
  SamOnnxModel interface (dynamic batch and point axes), built by the
  dependency-free graph builder (``export/onnx_graph.py``) and validated by
  the numpy evaluator (``export/onnx_eval.py``): the analogue of the
  reference's onnxruntime round trip.  Its bytes are the JAX package's for
  the same weights.

python -m samcarriestheburden_torch.cli.export_decoder \\
    --checkpoint <ckpt> --model-type vit_h --output decoder.pt2

``--checkpoint`` is a reference ``.pth`` or a JAX-package ``.npz``
(``models/build.py``).  Without ``--cpu`` the export runs on the card and
raises without one.  The reference's ``--gelu-approx`` is not carried, as in
the JAX CLI: ``Erf`` is core ONNX since opset 9.
"""

from __future__ import annotations

import argparse


def _validation_inputs(model, b, n):
    """Seeded random decoder inputs at batch ``b`` / ``n`` points (numpy,
    the JAX CLI's)."""
    import numpy as np

    emb = model.cfg.prompt_encoder.image_embedding_size
    g4 = emb[0] * 4
    td = model.cfg.mask_decoder.transformer_dim
    rng = np.random.default_rng(0)
    return (
        rng.standard_normal((1, td, *emb)).astype(np.float32),
        rng.uniform(0, model.img_size, (b, n, 2)).astype(np.float32),
        np.ones((b, n), np.int32),
        np.zeros((b, 1, g4, g4), np.float32),
        np.zeros((b,), np.float32),
        np.asarray([600, 800], np.int32),
    )


def _output_names(return_extra_metrics):
    names = ["masks", "prepadded_size", "iou_predictions"]
    if return_extra_metrics:
        names += ["stability_scores", "areas"]
    return names + ["low_res_masks"]


def _reference_outputs(model, args, test_args):
    """The eager program's outputs on ``test_args``, as numpy."""
    import torch

    from samcarriestheburden_torch.export.program import make_decoder_fn

    fn = make_decoder_fn(model, args.return_single_mask, args.use_stability_score,
                         args.return_extra_metrics)
    with torch.no_grad():
        outs = fn(*(torch.from_numpy(a).to(model.device) for a in test_args))
    return [o.cpu().numpy() for o in outs]


def _check_outputs(model, got, ref, names, quantize, artifact):
    """The validation contract of both formats (JAX ``_check_outputs``):
    atol = rtol = 1e-4 without quantization; with it, at least 99 % of the
    thresholded mask pixels equal to the fp32 program's."""
    import numpy as np

    if quantize is None:
        for name, r in zip(names, ref):
            np.testing.assert_allclose(got[name], np.asarray(r), atol=1e-4, rtol=1e-4)
        print(f"validation OK: {artifact} matches eager outputs")
    else:
        thr = model.mask_threshold
        agree = ((got["masks"] > thr) == (np.asarray(ref[0]) > thr)).mean()
        if agree < 0.99:
            raise RuntimeError(f"quantized {artifact} mask agreement {agree:.4f} < 0.99")
        print(f"validation OK: {quantize} {artifact} masks agree with fp32 "
              f"at {agree:.4%} of pixels")


def main(argv=None):
    p = argparse.ArgumentParser(description="Export the SAM prompt encoder and mask decoder.")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="The path to the SAM model checkpoint (.pth or JAX-format .npz).")
    p.add_argument("--output", type=str, required=True,
                   help="The filename to save the exported program to.")
    p.add_argument("--format", choices=["torch_export", "onnx"], default="torch_export",
                   help="torch_export for a torch.export artifact (.pt2) bound to the export "
                        "device; onnx for an onnxruntime/web-consumable artifact")
    p.add_argument("--model-type", type=str, required=True,
                   help="In ['default', 'vit_h', 'vit_l', 'vit_b', 'vit_t'].")
    p.add_argument("--return-single-mask", action="store_true",
                   help="Return only the best mask (score-reweight selection).")
    p.add_argument("--use-stability-score", action="store_true",
                   help="Replace the IoU head scores with stability scores.")
    p.add_argument("--return-extra-metrics", action="store_true")
    p.add_argument("--batch", type=int, default=None, help="Static batch size (default: symbolic)")
    p.add_argument("--num-points", type=int, default=None,
                   help="Static point count (default: symbolic)")
    p.add_argument("--quantize", choices=["bf16", "int8"], default=None,
                   help="Weight quantization for the exported artifact "
                        "(reference's dynamic uint8 ONNX quantization analogue)")
    p.add_argument("--validate", action="store_true",
                   help="Round-trip the serialized program and check outputs")
    p.add_argument("--cpu", action="store_true",
                   help="export on the CPU; default: the card")
    args = p.parse_args(argv)
    # flag validation that depends only on args runs before the checkpoint load
    if args.format == "onnx":
        if args.quantize == "bf16":
            p.error("--format onnx supports --quantize int8 (in-graph DequantizeLinear, the "
                    "reference's quantize_dynamic analogue); bf16 is a torch_export mode")
        if args.batch is not None or args.num_points is not None:
            p.error("--format onnx always exports dynamic batch/point axes")

    import numpy as np
    import torch

    from samcarriestheburden_torch.device import resolve_device
    from samcarriestheburden_torch.export.program import (INPUT_NAMES, export_decoder,
                                                          load_exported)
    from samcarriestheburden_torch.models.build import sam_model_registry

    device = resolve_device("cpu" if args.cpu else None)
    print("Loading model...")
    model = sam_model_registry[args.model_type](checkpoint=args.checkpoint, device=device)

    if args.format == "onnx":
        from samcarriestheburden_torch.export.onnx_graph import export_decoder_onnx

        path = export_decoder_onnx(
            model, args.output, return_single_mask=args.return_single_mask,
            use_stability_score=args.use_stability_score,
            return_extra_metrics=args.return_extra_metrics, quantize=args.quantize)
        print(f"wrote {path} ({path.stat().st_size} bytes)")
        if args.validate:
            from samcarriestheburden_torch.export.onnx_eval import evaluate_model

            test_args = _validation_inputs(model, 1, 2)
            feeds = dict(zip(INPUT_NAMES, test_args))
            # the ONNX interface takes labels as float (SamOnnxModel)
            feeds["point_labels"] = feeds["point_labels"].astype(np.float32)
            got = evaluate_model(path.read_bytes(), feeds)
            ref = _reference_outputs(model, args, test_args)
            _check_outputs(model, got, ref, _output_names(args.return_extra_metrics),
                           args.quantize, "parsed .onnx graph")
        return path

    path = export_decoder(model, args.output, return_single_mask=args.return_single_mask,
                          use_stability_score=args.use_stability_score,
                          return_extra_metrics=args.return_extra_metrics,
                          batch=args.batch, num_points=args.num_points, quantize=args.quantize)
    print(f"wrote {path} ({path.stat().st_size} bytes)")

    if args.validate:
        exported = load_exported(path)
        test_args = _validation_inputs(model, args.batch or 1, args.num_points or 2)
        with torch.no_grad():
            outs = exported(*(torch.from_numpy(a).to(device) for a in test_args))
        names = _output_names(args.return_extra_metrics)
        got = {k: v.cpu().numpy() for k, v in zip(names, outs)}
        ref = _reference_outputs(model, args, test_args)
        _check_outputs(model, got, ref, names, args.quantize, "loaded torch.export program")
    return path


if __name__ == "__main__":
    main()
