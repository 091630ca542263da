"""OWOD dataset split tooling (reference datasets_utils/owod/
owod_dataset_utils.py + coco_ood/create_txts_in_ultralytics_format.py):
write train/val/test image-list txts from VOC + COCO directory layouts and
from UnSniffer JSON annotation files."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Sequence

IMG_EXTS = (".jpg", ".jpeg", ".png")


def write_split_txt(image_dirs: Sequence[str], out_txt: str,
                    relative_to: str | None = None) -> int:
    """List every image under image_dirs into out_txt (one path per line,
    './'-relative when relative_to is given)."""
    lines = []
    for d in image_dirs:
        for p in sorted(Path(d).rglob("*")):
            if p.suffix.lower() in IMG_EXTS:
                if relative_to:
                    lines.append("./" + str(p.relative_to(relative_to)))
                else:
                    lines.append(str(p))
    Path(out_txt).parent.mkdir(parents=True, exist_ok=True)
    Path(out_txt).write_text("\n".join(lines) + "\n")
    return len(lines)


def write_task_stems_txt(stems: Iterable[str], out_txt: str) -> int:
    stems = sorted(set(stems))
    Path(out_txt).parent.mkdir(parents=True, exist_ok=True)
    Path(out_txt).write_text("\n".join(stems) + "\n")
    return len(stems)


def unsniffer_json_to_txt(json_file: str, img_dir: str, out_txt: str,
                          relative_to: str | None = None) -> int:
    """Image-list txt from an UnSniffer annotation JSON (reference
    datasets_utils/coco_ood/create_txts_in_ultralytics_format.py)."""
    anns = json.loads(Path(json_file).read_text())
    lines = []
    for im in anns["images"]:
        p = Path(img_dir) / im["file_name"]
        if relative_to:
            lines.append("./" + str(p.relative_to(relative_to)))
        else:
            lines.append(str(p))
    Path(out_txt).parent.mkdir(parents=True, exist_ok=True)
    Path(out_txt).write_text("\n".join(sorted(lines)) + "\n")
    return len(lines)
