"""Training-session persistence (the counterpart of the JAX package's
unet_studio_tpu/config/session.py; reference: the .ini session files and
QSettings, mainwindow_training.cpp:22-74, optiontablewidget.cpp:437-441),
as JSON: image and label lists, hyperparameters, the model path and the
augmentation option overrides; and the per-user settings file.
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


class Settings:
    """Persisted per-user defaults (the QSettings analog): option
    overrides, recent directories, the last network; the JAX package's
    file and keys."""

    def __init__(self, path: str | None = None):
        self.path = path or os.path.expanduser("~/.config/unet_studio_tpu.json")
        self._data: dict = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self._data = json.load(f)
            except (OSError, json.JSONDecodeError):
                self._data = {}

    def value(self, key: str, default=None):
        return self._data.get(key, default)

    def set(self, key: str, value) -> None:
        self._data[key] = value

    def save(self) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._data, f, indent=1)
        os.replace(tmp, self.path)
