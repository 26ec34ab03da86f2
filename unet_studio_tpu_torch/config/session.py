"""Training-session persistence (the counterpart of the JAX package's
unet_studio_tpu/config/session.py; reference: the .ini session files and
QSettings, mainwindow_training.cpp:22-74, optiontablewidget.cpp:437-441),
as JSON: image and label lists, hyperparameters, the model path and the
augmentation option overrides.
"""

from __future__ import annotations

import json
import os


def save_session(path: str, *, images, labels, model_path, batch_size, learning_rate, epoch,
                 is_label=True, seed=0, options=None) -> None:
    data = {
        "images": list(images),
        "labels": list(labels),
        "model_path": model_path,
        "batch_size": batch_size,
        "learning_rate": learning_rate,
        "epoch": epoch,
        "is_label": bool(is_label),
        "seed": seed,
        "options": dict(options or {}),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1)
    os.replace(tmp, path)


def load_session(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
