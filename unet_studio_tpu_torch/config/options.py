"""The augmentation and post-processing option tables (ids, defaults,
hints): the source of the CLI's option flags and the UI's option tree, a
copy of the JAX package's tables, and the parser
of the reference's option files (reference: options.txt, postproc.txt,
optiontablewidget.cpp:478-508).

Line grammar: ``Category/Title/id/type-spec/default/hint`` with type-spec
``Off:25%:50%:75%:On`` (kind ``prob``, int 0..4),
``float:min:max:step:decimals``, ``int:min:max:step`` or ``button``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class OptionItem:
    category: str
    title: str
    id: str
    kind: str  # "prob" | "float" | "int" | "button"
    default: float
    minimum: float = 0.0
    maximum: float = 0.0
    step: float = 0.0
    decimals: int = 0
    hint: str = ""


def parse_option_line(line: str) -> OptionItem | None:
    """One option-file line -> an OptionItem, or None for a line with
    fewer than six fields."""
    parts = line.rstrip("\n").split("/")
    if len(parts) < 6:
        return None
    category, title, oid, type_spec, default, hint = parts[:6]
    default_f = float(default.rstrip("f"))
    ts = type_spec.split(":")
    if ts[0] == "float":
        return OptionItem(category, title, oid, "float", default_f, float(ts[1]), float(ts[2]),
                          float(ts[3]), int(ts[4]) if len(ts) > 4 else 2, hint)
    if ts[0] == "int":
        return OptionItem(category, title, oid, "int", default_f, float(ts[1]), float(ts[2]),
                          float(ts[3]), 0, hint)
    if ts[0] == "button":
        return OptionItem(category, title, oid, "button", default_f, hint=hint)
    # probability combo (Off:25%:50%:75%:On)
    return OptionItem(category, title, oid, "prob", default_f, 0, 4, 1, 0, hint)


def load_options_file(path: str) -> list[OptionItem]:
    items = []
    with open(path) as f:
        for line in f:
            item = parse_option_line(line)
            if item:
                items.append(item)
    return items


def _prob(cat, title, oid, default, hint):
    return OptionItem(cat, title, oid, "prob", default, 0, 4, 1, 0, hint)


def _flt(cat, title, oid, lo, hi, step, dec, default, hint):
    return OptionItem(cat, title, oid, "float", default, lo, hi, step, dec, hint)


def _int(cat, title, oid, lo, hi, step, default, hint):
    return OptionItem(cat, title, oid, "int", default, lo, hi, step, 0, hint)


def _btn(cat, title, oid, hint):
    return OptionItem(cat, title, oid, "button", 0, hint=hint)


# Augmentation options (ids/defaults == reference options.txt:1-39)
OPTION_TABLE: tuple[OptionItem, ...] = (
    _prob("Reduction", "Cropping", "cropping", 0, "Apply signal cropping"),
    _flt("Reduction", "├Minimum Size", "cropping_size_min", 0, 1, 0.05, 2, 0.1,
         "minimum size of cropping in proportion to image width"),
    _flt("Reduction", "└Maximum Size", "cropping_size_max", 0, 1, 0.05, 2, 0.2,
         "maximum size of cropping in proportion to image width"),
    _prob("Reduction", "Truncation Z", "truncation_z", 1, "Apply signal cropping"),
    _prob("Reduction", "Downsample X", "downsample_x", 2, "apply downsample of data"),
    _flt("Reduction", "└Ratio", "downsample_x_ratio", 0, 1, 0.1, 2, 0.5, "the downsample ratio"),
    _prob("Reduction", "Downsample Y", "downsample_y", 2, "apply downsample of data"),
    _flt("Reduction", "└Ratio", "downsample_y_ratio", 0, 1, 0.1, 2, 0.5, "the downsample ratio"),
    _prob("Reduction", "Downsample Z", "downsample_z", 2, "apply downsample of data"),
    _flt("Reduction", "└Ratio", "downsample_z_ratio", 0, 1, 0.1, 2, 0.5, "the downsample ratio"),
    _prob("Reduction", "Noise", "noise", 2, "add uniform noise"),
    _flt("Reduction", "└Magnitude", "noise_mag", 0, 1, 0.1, 2, 0.2, "magnitude of uniform noise"),
    _prob("Lighting", "Ambient Light", "ambient", 2, "add ambient light"),
    _flt("Lighting", "└Magnitude", "ambient_mag", 0, 4, 0.5, 2, 2.0, "The magnitude of ambient light"),
    _prob("Lighting", "Diffuse Light", "diffuse", 2, "add diffuse light"),
    _flt("Lighting", "└Magnitude", "diffuse_mag", 0, 2, 0.1, 2, 2.0, "The magnitude of diffuse light"),
    _prob("Lighting", "Specular Light", "specular", 2, "add specular light"),
    _flt("Lighting", "├Frequency", "specular_freq", 0, 10, 0.1, 2, 2.0, "The frequency of specular light"),
    _flt("Lighting", "└Magnitude", "specular_mag", 0, 2, 0.1, 2, 0.5, "The magnitude of specular light"),
    _flt("Rigid Motion", "Translocation", "translocation_ratio", 0, 1, 0.05, 2, 0.2,
         "upper limit of translocation in the ratio of image dimension"),
    _flt("Rigid Motion", "Rotation X", "rotation_x", 0, 2, 0.05, 2, 0.2, "upper limit of rotation at x axis"),
    _flt("Rigid Motion", "Rotation Y", "rotation_y", 0, 2, 0.05, 2, 0.2, "upper limit of rotation at y axis"),
    _flt("Rigid Motion", "Rotation Z", "rotation_z", 0, 2, 0.05, 2, 0.2, "upper limit of rotation at z axis"),
    _flt("Camera Transform", "Zoom Out", "scaling_up", 1, 5, 0.05, 2, 1.25, "upper limit of scaling up"),
    _flt("Camera Transform", "Zoom In", "scaling_down", 0.05, 1, 0.05, 2, 0.8, "lower limit of scaling down"),
    _flt("Camera Transform", "Aspect Ratio", "aspect_ratio", 1, 2, 0.05, 2, 1.25,
         "upper limit of relative scaling at axis"),
    _flt("Camera Transform", "Perspective", "perspective", 0, 0.5, 0.05, 2, 0.1,
         "upper limit of perspective transform"),
    _flt("Camera Transform", "Lens Distortion", "lens_distortion", 0, 0.5, 0.01, 2, 0.1,
         "upper limit of lens distortion"),
    _prob("Camera Transform", "Distortion", "distortion", 1, "apply nonlinear deformation"),
    _int("Camera Transform", "├Foci Count", "distortion_count", 1, 10, 1, 3, "number of distortion foci"),
    _flt("Camera Transform", "├Minimum Radius", "distortion_radius_min", 0.1, 0.5, 0.1, 2, 0.1,
         "minimum distortion radius"),
    _flt("Camera Transform", "├Maximum Radius", "distortion_radius_max", 0.1, 1, 0.1, 2, 0.5,
         "maximum distortion radius"),
    _flt("Camera Transform", "├Minimum Magnitude", "distortion_mag_min", 0, 0.5, 0.05, 2, 0.05,
         "minimum distortion magnitude"),
    _flt("Camera Transform", "└Maximum Magnitude", "distortion_mag_max", 0, 0.5, 0.05, 2, 0.1,
         "maximum distortion magnitude"),
    _prob("Background", "Zero Background", "zero_background", 1, "Set background to zero"),
    _prob("Background", "Rubber-Stamping", "rubber_stamping", 2, "Add background"),
    _flt("Background", "└Magnitude", "rubber_stamping_mag", 0, 1, 0.1, 2, 0.5,
         "The magnitude of background images"),
    _prob("Background", "Perlin Texture", "perlin_texture", 2, "Add Perlin noise"),
    _flt("Background", "└Magnitude", "perlin_texture_mag", 0, 1, 0.1, 2, 0.5,
         "The magnitude of background images"),
)

# Post-processing actions (ids/defaults == reference postproc.txt:1-18)
POSTPROC_TABLE: tuple[OptionItem, ...] = (
    _btn("Post-processing", "Defragment", "defragment", "zero background region using summed probability"),
    _flt("Post-processing", "├Threshold", "defragment_threshold", 0, 1, 0.1, 2, 0.5,
         "threshold for removing the background on summed image"),
    _int("Post-processing", "└Smoothing", "defragment_smoothing", 1, 5, 1, 1, "number of smoothing applied"),
    _btn("Post-processing", "Minus", "minus", "minus a value to each volume"),
    _flt("Post-processing", "└Value", "minus_value", 0, 1, 0.1, 2, 0.5, "value"),
    _btn("Post-processing", "Defragment Each", "defragment_each", "remove fragments"),
    _flt("Post-processing", "└Threshold", "defragment_each_threshold", 0, 1, 0.1, 2, 0.25,
         "threshold for removing fragments"),
    _btn("Post-processing", "Upper Threshold", "upper_threshold", "apply a upper threshold"),
    _flt("Post-processing", "└Threshold", "upper_threshold_threshold", 0, 5, 0.1, 2, 1.0, "threshold"),
    _btn("Post-processing", "Lower Threshold", "lower_threshold", "apply a lower threshold"),
    _flt("Post-processing", "└Threshold", "lower_threshold_threshold", 0, 5, 0.1, 2, 0.0, "threshold"),
    _btn("Post-processing", "Normalize Each", "normalize_each", "normalize each volume"),
    _btn("Post-processing", "Gaussian Smoothing", "gaussian_smoothing", "apply Gaussian smoothing"),
    _btn("Post-processing", "Anisotropic Smoothing", "anisotropic_smoothing", "apply anisotropic smoothing"),
    _btn("Post-processing", "Soft Max", "soft_max", "calculate soft max"),
    _flt("Post-processing", "└Probability threshold", "soft_max_prob", 0, 1, 0.1, 2, 0.5,
         "probability threshold"),
    _btn("Post-processing", "Binarize", "binarize", "binarize the values"),
    _flt("Post-processing", "└Threshold", "binarize_threshold", 0, 1, 0.1, 2, 0.5,
         "threshold for threshold value to 0 and 1"),
)


def default_option_values() -> dict[str, float]:
    return {o.id: o.default for o in OPTION_TABLE}
