"""Detectron2 checkpoint converter (port of `moco_tpu/export_detectron2.py`,
the reference's `detection/convert-pretrain-to-detectron2.py`).

The transfer path's last step: take an exported encoder in the reference's
checkpoint dialect (`checkpoint.export_encoder_q`, `.npz` or
`.safetensors`), strip `module.encoder_q.`, rename torchvision's ResNet
keys to Detectron2's R50-C4 names, and write a `.pkl` that Detectron2's
checkpointer loads with `matching_heuristics`.

Name map (torchvision -> Detectron2 R50-C4):
    conv1.*                      -> `stem.conv1.*`
    bn1.{w,b,rm,rv}              -> `stem.conv1.norm.{weight,bias,running_mean,running_var}`
    layer{i}.{j}.convK/bnK       -> `res{i+1}.{j}.convK{,.norm}`
    layer{i}.{j}.downsample.0/1  -> `res{i+1}.{j}.shortcut{,.norm}`
    fc.*                         -> dropped (detection has no classifier head)

    python -m moco_tpu_torch.export_detectron2 encoder.npz out.pkl
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

from moco_tpu_torch.checkpoint import detect_dialect, import_encoder_q

_BN_LEAVES = {
    "weight": "norm.weight",
    "bias": "norm.bias",
    "running_mean": "norm.running_mean",
    "running_var": "norm.running_var",
}


def torchvision_flat_to_detectron2(flat: dict[str, np.ndarray],
                                   prefix: str = "module.encoder_q.") -> dict[str, np.ndarray]:
    """The `prefix` entries of a torchvision-named flat dict under
    Detectron2's C4 names; the head and `num_batches_tracked` dropped."""
    out: dict[str, np.ndarray] = {}
    for name, arr in flat.items():
        if not name.startswith(prefix):
            continue
        name = name[len(prefix):]
        parts = name.split(".")
        if parts[0].startswith("fc") or parts[-1] == "num_batches_tracked":
            continue
        if parts[0] == "conv1":
            out["stem.conv1." + ".".join(parts[1:])] = np.asarray(arr)
        elif parts[0] == "bn1":
            out["stem.conv1." + _BN_LEAVES[parts[1]]] = np.asarray(arr)
        elif parts[0].startswith("layer"):
            stage = int(parts[0][len("layer"):])
            base = f"res{stage + 1}.{parts[1]}"
            rest = parts[2:]
            if rest[0].startswith("conv"):
                out[f"{base}.{rest[0]}.{'.'.join(rest[1:])}"] = np.asarray(arr)
            elif rest[0].startswith("bn"):
                conv = "conv" + rest[0][len("bn"):]
                out[f"{base}.{conv}.{_BN_LEAVES[rest[1]]}"] = np.asarray(arr)
            elif rest[0] == "downsample":
                leaf = ("shortcut." + ".".join(rest[2:]) if rest[1] == "0"
                        else "shortcut." + _BN_LEAVES[rest[2]])
                out[f"{base}.{leaf}"] = np.asarray(arr)
            else:
                raise ValueError(f"unexpected key {name!r}")
        else:
            raise ValueError(f"unexpected key {name!r}")
    if not out:
        raise ValueError(f"no {prefix}* entries found")
    return out


def convert(src: str, dst: str, prefix: str = "module.encoder_q.") -> dict:
    """Write `src`'s encoder as a Detectron2 `.pkl` at `dst`; returns the
    model dict written."""
    flat = import_encoder_q(src)
    if prefix == "module.encoder_q.":
        # a ViT or v3-tree export has no C4 mapping: say so up front; a
        # custom prefix names the caller's own dialect
        dialect = detect_dialect(flat)
        if dialect != "torchvision_encoder_q":
            raise ValueError(f"{src!r} is a {dialect!r} checkpoint; only the torchvision "
                             "`module.encoder_q.*` ResNet dialect maps onto Detectron2 C4 "
                             "names (ViT/v3-tree backbones have no C4 equivalent)")
    model = torchvision_flat_to_detectron2(flat, prefix)
    with open(dst, "wb") as f:
        pickle.dump({"model": model, "__author__": "moco_tpu", "matching_heuristics": True}, f)
    return model


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("input", help="exported encoder (.npz / .safetensors)")
    parser.add_argument("output", help="Detectron2-format .pkl")
    parser.add_argument("--prefix", default="module.encoder_q.")
    args = parser.parse_args(argv)
    model = convert(args.input, args.output, args.prefix)
    print(f"wrote {args.output} with {len(model)} tensors", flush=True)


if __name__ == "__main__":
    main()
