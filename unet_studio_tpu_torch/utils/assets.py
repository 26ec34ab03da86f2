"""Startup asset discovery (reference: main.cpp:28-82; the counterpart of
unet_studio_tpu/utils/assets.py).

``<root>/atlas/<name>/`` directories hold a ``<name>_tissue.nii.gz``
segmentation template and sibling atlas NIfTIs, ranked by species
human -> chimpanzee -> rhesus -> marmoset -> rat -> mouse; the model zoo
is ``<root>/unet/*.nz``.
"""

from __future__ import annotations

import glob
import os

SPECIES_RANK = ("human", "chimpanzee", "rhesus", "marmoset", "rat", "mouse")


def _rank(name: str) -> int:
    for i, k in enumerate(SPECIES_RANK):
        if k in name:
            return i
    return len(SPECIES_RANK)


def find_asset_root(explicit: str | None = None) -> str | None:
    """Look for an atlas dir at ``explicit``, next to the package, then in
    the CWD."""
    candidates = []
    if explicit:
        candidates.append(explicit)
    candidates.append(os.path.join(os.path.dirname(__file__), "..", ".."))
    candidates.append(os.getcwd())
    for c in candidates:
        if os.path.isdir(os.path.join(c, "atlas")):
            return os.path.abspath(c)
    return None


def scan_templates(root: str | None):
    """(segmentation templates, atlas files of each): one template per
    species directory, species-ranked (main.cpp:30-82)."""
    seg_templates: list[str] = []
    atlas_lists: list[list[str]] = []
    if root is None:
        return seg_templates, atlas_lists
    atlas_dir = os.path.join(root, "atlas")
    if not os.path.isdir(atlas_dir):
        return seg_templates, atlas_lists
    names = sorted((d for d in os.listdir(atlas_dir)
                    if os.path.isdir(os.path.join(atlas_dir, d))), key=_rank)
    for name in names:
        t_dir = os.path.join(atlas_dir, name)
        tissue = os.path.join(t_dir, f"{name}_tissue.nii.gz")
        if not os.path.exists(tissue):
            continue
        seg_templates.append(tissue)
        files = sorted(f for f in os.listdir(t_dir) if f.endswith((".nii", ".nii.gz")))
        atlas_lists.append([os.path.join(t_dir, f) for f in files if f.split("_")[0] != name])
    return seg_templates, atlas_lists


def zoo_models(root: str | None) -> list[str]:
    if root is None:
        return []
    return sorted(glob.glob(os.path.join(root, "unet", "*.nz")))
