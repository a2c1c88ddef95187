"""Build the dataset index: the JSON index the Ruijin datasets read.

    python -m jointimagegeneration_torch.cli.build_index <root> <out_index.json> \
        [--image-glob "*image.nii.gz"] [--seg-glob "*totalseg.nii.gz"] \
        [--tumor-glob "*crcseg.nii.gz"] [--texts texts.json] [--bert <model dir> [--device cpu]]

The port's copy of `jointimagegeneration_tpu/cli/build_index.py`.  Every
directory under `root` that holds a TotalSegmentator volume is a case, named
after the directory: {"image", "totalseg", "crcseg"} are the first file each
glob matches there, written relative to the index's directory when they lie
under it (absolute otherwise), and "text" the case's report from `--texts`
(a JSON {case: text}).  `--bert` names a local BERT model directory (it needs
`transformers`; nothing is downloaded): each report's frozen features
(`nn.text.FrozenBERTEmbedder`, (T, 768) float32, computed on the card unless
`--device cpu` is given) go to
`<root>/text_features/<case>.npz` under the key `features`, and the index
names that file as "text_features", the context stage 1 trains on.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["main"]


def _relative(path: Path, base: Path) -> str:
    path = path.resolve()
    return str(path.relative_to(base)) if path.is_relative_to(base) else str(path)


def main(argv: Optional[list] = None) -> dict:
    """Write the index; returns it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("out")
    ap.add_argument("--image-glob", default="*image.nii.gz")
    ap.add_argument("--seg-glob", default="*totalseg.nii.gz")
    ap.add_argument("--tumor-glob", default="*crcseg.nii.gz")
    ap.add_argument("--texts", help="JSON {case: report text}")
    ap.add_argument("--bert", help="local BERT model directory for the text features")
    ap.add_argument("--device", help="where BERT runs (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    root = Path(args.root).resolve()
    out_dir = Path(args.out).resolve().parent  # the datasets resolve paths against it
    texts = json.loads(Path(args.texts).read_text()) if args.texts else {}
    index = {}
    for case_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        entry = {}
        for key, glob in (("image", args.image_glob), ("totalseg", args.seg_glob), ("crcseg", args.tumor_glob)):
            hits = sorted(case_dir.glob(glob))
            if hits:
                entry[key] = _relative(hits[0], out_dir)
        if "totalseg" not in entry:
            continue
        if case_dir.name in texts:
            entry["text"] = texts[case_dir.name]
        index[case_dir.name] = entry

    if args.bert:
        from ..nn.text import FrozenBERTEmbedder

        bert = FrozenBERTEmbedder(args.bert, device=args.device)
        feat_dir = root / "text_features"
        feat_dir.mkdir(exist_ok=True)
        for name, entry in index.items():
            if "text" in entry:
                out = feat_dir / f"{name}.npz"
                np.savez_compressed(out, features=bert(entry["text"])[0])
                entry["text_features"] = _relative(out, out_dir)

    Path(args.out).write_text(json.dumps(index, indent=2))
    print(f"indexed {len(index)} cases -> {args.out}")
    return index


if __name__ == "__main__":
    main()
