"""Command-line interface of the port: the JAX package's parser
(unet_studio_tpu/cli.py), flag for flag, with ``--device`` choosing
where it runs (default ``cuda``).

    python -m unet_studio_tpu_torch --action train --model m.nz \\
        --bids bids_dir [--batch_size 2 --epoch 100 ...] [--device cpu|cuda]
    python -m unet_studio_tpu_torch --action evaluate --model m.nz \\
        --source img.nii.gz [--device cpu|cuda] [--compute_dtype float32] \\
        [--template 0 --atlas atlas.nii.gz --asset_root dir] [--mosaic out.png]
    python -m unet_studio_tpu_torch --action qc --model m.nz --bids bids_dir \\
        [--device cpu|cuda] [--compute_dtype float32]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from .config.options import OPTION_TABLE, default_option_values
from .utils.assets import find_asset_root, scan_templates


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="unet-studio-tpu-torch",
        description="3D U-Net brain segmentation on an NVIDIA GPU (train/evaluate/qc)",
    )
    p.add_argument("--action", choices=["train", "evaluate", "qc"], required=True)
    p.add_argument("--model", required=True, help="model .nz path or zoo name")
    p.add_argument("--source", help="evaluate: input file(s)/directory")
    p.add_argument("--bids", help="train/qc: comma-separated BIDS roots")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N, or cpu; with no GPU only cpu runs")
    p.add_argument(
        "--thread_count", type=int, default=min(8, os.cpu_count() or 1),
        help="host worker threads: the QC load/resample pool and the evaluate "
        "post-processing pool (qc.cpp:273)",
    )
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--epoch", type=int, default=10000)
    p.add_argument("--is_label", type=int, default=1)
    p.add_argument("--cost_ce", type=int, default=1)
    p.add_argument("--cost_dice", type=int, default=1)
    p.add_argument("--cost_mse", type=int, default=1)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--in_count", type=int, default=1)
    p.add_argument("--out_count", type=int, default=None)
    p.add_argument("--architecture", default=None)
    p.add_argument("--label_weight", default=None)
    p.add_argument("--file_list", default=None)
    p.add_argument("--template", default=None)
    p.add_argument("--atlas", default=None)
    p.add_argument("--output_type", type=int, default=0)
    p.add_argument("--asset_root", default=None, help="dir containing atlas/ and unet/")
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator address host:port (not ported yet)")
    p.add_argument("--session", default=None, help="load a training session JSON")
    p.add_argument("--save_session", default=None, help="write the training session JSON")
    p.add_argument("--mosaic", default=None, help="evaluate: also export a PNG slice mosaic")
    p.add_argument("--data_parallel", type=int, default=None,
                   help="number of devices on the data axis (not ported yet)")
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    for item in OPTION_TABLE:
        p.add_argument(f"--{item.id}", type=float, default=None, help=item.hint)
    return p


def get_files(source: str) -> list[str]:
    if os.path.isdir(source):
        return sorted(glob.glob(os.path.join(source, "*.nii.gz")) +
                      glob.glob(os.path.join(source, "*.nii")))
    if any(ch in source for ch in "*?["):
        return sorted(glob.glob(source))
    return [s for s in source.split(",") if s]


def resolve_model_path(args) -> str:
    from .models.serialize import get_model_path

    root = find_asset_root(args.asset_root)
    zoo = os.path.join(root, "unet") if root else None
    return get_model_path(args.model, zoo)


def cmd_train(args) -> int:
    from .data.bids import get_bids_pairs
    from .engine.train import TrainEngine, TrainParam
    from .io.nifti import read_nifti
    from .models.dsl import default_architecture
    from .models.serialize import load_model, save_model
    from .models.unet3d import UNet3d, round_up_size
    from .ops.augment import AugOptions

    if args.data_parallel or args.coordinator:
        print("error: --data_parallel and --coordinator are not ported yet", file=sys.stderr)
        return 1
    if args.session:
        from .config.session import load_session

        sess = load_session(args.session)
        images, labels = sess["images"], sess["labels"]
        args.model = sess.get("model_path", args.model)
        args.batch_size = sess.get("batch_size", args.batch_size)
        args.learning_rate = sess.get("learning_rate", args.learning_rate)
        args.epoch = sess.get("epoch", args.epoch)
        args.seed = sess.get("seed", args.seed)
        for k, v in sess.get("options", {}).items():
            if getattr(args, k, None) is None:
                setattr(args, k, v)
    elif not args.bids:
        print("error: please specify --bids", file=sys.stderr)
        return 1
    else:
        images, labels = get_bids_pairs(args.bids)
    print(f"{len(images)} matched pairs")

    if args.file_list:
        with open(args.file_list, "w") as f:
            for i, lab in zip(images, labels):
                f.write(f"{os.path.basename(i)}=>{os.path.basename(lab)}\n")

    model_path = resolve_model_path(args)
    if os.path.exists(model_path):
        print(f"loading existing model {model_path}")
        try:
            model = load_model(model_path, device=args.device)
        except (OSError, ValueError) as exc:  # train.cpp:1110-1111
            print(f"error: failed to load model from {model_path}: {exc}", file=sys.stderr)
            return 1
    else:
        try:
            lbl = read_nifti(labels[0])
            img = read_nifti(images[0])
        except (OSError, ValueError) as exc:  # train.cpp:1119-1122
            print(f"error: cannot load label/image file: {exc}", file=sys.stderr)
            return 1
        out_count = args.out_count or int(np.max(lbl.data)) + 1
        architecture = args.architecture or default_architecture(out_count)
        model = UNet3d.create(args.in_count, out_count, architecture, seed=0, device=args.device)
        model.dim = round_up_size(img.shape_xyz, 32)
        model.voxel_size = np.asarray(img.voxel_size, np.float32)
        print(f"dim: {model.dim}")
        print(f"vs: {tuple(float(v) for v in model.voxel_size)}")

    opts = default_option_values()
    for item in OPTION_TABLE:
        v = getattr(args, item.id, None)
        if v is not None:
            opts[item.id] = v
    seed = args.seed
    if seed is None:
        seed = len(model.testing_errors) // 3 // args.epoch  # train.cpp:1148
    param = TrainParam(
        image_file_name=images, label_file_name=labels, batch_size=args.batch_size,
        epoch=args.epoch, learning_rate=args.learning_rate, seed=seed,
        is_label=bool(args.is_label), cost_ce=bool(args.cost_ce),
        cost_dice=bool(args.cost_dice), cost_mse=bool(args.cost_mse),
        options=AugOptions.from_dict(opts), compute_dtype=args.compute_dtype,
    )
    if args.save_session:
        from .config.session import save_session

        save_session(args.save_session, images=images, labels=labels, model_path=model_path,
                     batch_size=param.batch_size, learning_rate=param.learning_rate,
                     epoch=param.epoch, is_label=param.is_label, seed=param.seed,
                     options=opts)

    engine = TrainEngine(model, param, model_path=model_path, device=args.device)
    engine.start()
    if engine.error_msg:
        print(f"error: {engine.error_msg}", file=sys.stderr)
        return 1
    print(f"starting epoch: {engine.cur_epoch}")
    engine.run()
    if engine.error_msg:
        print(f"error: {engine.error_msg}", file=sys.stderr)
        return 1
    final = model_path + ".final.nz"
    print(f"save model to {final}")
    save_model(final, model)
    return 0


def cmd_evaluate(args) -> int:
    import torch

    from .engine.evaluate import EvaluateEngine
    from .models.serialize import load_model

    if not args.source:
        print("error: please specify --source", file=sys.stderr)
        return 1
    files = get_files(args.source)
    if not files:
        print("error: no file specified at --source", file=sys.stderr)
        return 1
    model_path = resolve_model_path(args)
    if not os.path.exists(model_path):
        print(f"error: cannot find the network file {model_path}", file=sys.stderr)
        return 1
    print(f"loading network {model_path}")
    model = load_model(model_path, device=args.device)
    print(model.get_info())

    if args.template is not None and args.atlas is not None:
        err = load_parcellation(args)
        if err:
            print(f"error: {err}", file=sys.stderr)
            return 1

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    engine = EvaluateEngine(model, compute_dtype=dtype,
                            post_workers=min(4, args.thread_count), device=args.device)
    for case in engine.run(files):
        if case.error_msg:
            print(f"error: {case.error_msg}", file=sys.stderr)
            return 1
        out = case.path + ".result.nii.gz"
        print(f"save to {out}")
        if not engine.save_case(case, out, args.output_type):
            print(f"error: cannot save {out}", file=sys.stderr)
            return 1
        if args.mosaic:
            from .io.nifti import canonicalize_lps, read_nifti
            from .utils.mosaic import save_mosaic_png

            vol = canonicalize_lps(read_nifti(case.path)).data.astype(float)
            if vol.ndim == 4:
                vol = vol[0]
            save_mosaic_png(args.mosaic, vol, case.label)
            print(f"mosaic saved to {args.mosaic}")
    return 0


def load_parcellation(args) -> str:
    """Load ``--template`` (a path, or an index into the asset root's
    templates) and ``--atlas`` (evaluate.hpp:26-41); returns an error
    message, or "" on success.  An index past the templates is an error,
    as in the C++ original."""
    from .engine.atlas import AtlasParcellation

    seg_list, atlas_lists = scan_templates(find_asset_root(args.asset_root))
    tmpl, atlas = args.template, args.atlas
    if tmpl.isdigit():
        idx = int(tmpl)
        if idx >= len(seg_list):
            return f"--template {idx}: no such template ({len(seg_list)} found)"
        tmpl = seg_list[idx]
        if not os.path.exists(atlas) and atlas_lists[idx]:
            atlas = atlas_lists[idx][0]
    parc = AtlasParcellation(device=args.device)
    if not parc.load_template(tmpl) or not parc.load_atlas(atlas):
        return parc.error_msg
    print(f"atlas loaded: {parc.atlas_region_count} regions")
    return ""


def cmd_qc(args) -> int:
    import torch

    from .data.bids import get_bids_pairs
    from .engine.qc import run_qc
    from .models.serialize import load_model

    if not args.bids:
        print("error: please specify --bids", file=sys.stderr)
        return 1
    images, labels = get_bids_pairs(args.bids)
    model_path = resolve_model_path(args)
    if not os.path.exists(model_path):
        print(f"error: cannot find model {model_path}", file=sys.stderr)
        return 1
    model = load_model(model_path, device=args.device)
    stem = os.path.basename(model_path)
    if stem.endswith(".nz"):
        stem = stem[: -len(".nz")]
    report = os.path.join(os.path.dirname(model_path) or ".", stem + ".error_report.tsv")
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    run_qc(model, images, labels, report, compute_dtype=dtype, n_workers=args.thread_count,
           device=args.device)
    print(f"QC report saved to {report}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # boot-time accelerator probe + self-test (check_cuda, main.cpp:93-102);
    # raises when --device asks for a card that is not there
    from .utils.device import check_cuda

    err = check_cuda(args.device)
    if err:
        print(f"warning: {err}", file=sys.stderr)
    if args.action == "train":
        return cmd_train(args)
    if args.action == "qc":
        return cmd_qc(args)
    return cmd_evaluate(args)


if __name__ == "__main__":
    raise SystemExit(main())
