"""Solver and pipeline configuration.

``PatchMatchParams`` mirrors the algorithmic constants of the reference
(include/PatchMatch.h:48-67 plus kernel literals); ``ConfigParams`` the YAML
pipeline config (include/utility.h:28-47, config/config.yaml). Field names,
defaults and the YAML schema are those of ``mpmvs_tpu.params`` so that
configurations carry over unchanged.

Left out on purpose: the TPU execution knobs of the JAX package
(``dispatch``, ``src_quant8``, ``debug_skip_*``). Here the NCC
implementation follows the device of the tensors it is given: the CUDA
kernels for CUDA tensors, the plain PyTorch versions for CPU tensors.
``sampler`` keeps the JAX package's choice of path for incoherent fields
(``interop.params_from_jax_fields`` maps its values).
"""

from __future__ import annotations

import dataclasses
import re

SAMPLERS = ("auto", "sorted")


@dataclasses.dataclass(frozen=True)
class PatchMatchParams:
    """Static solver hyperparameters."""

    max_iterations: int = 3          # photometric iters per scale (PatchMatch.cpp:664)
    geom_iterations: int = 2         # iters in a geometric pass (PatchMatch.cpp:659)
    ncc_taps_per_axis: int = 6       # NCC taps per axis (6x6 = 36, PatchMatch.cu:341-373)
    sigma_spatial: float = 5.0       # bilateral weights (PatchMatch.h:54)
    sigma_color: float = 3.0         # (PatchMatch.h:55)
    top_k: int = 4                   # initial view selection (PatchMatch.h:56)
    max_scale: int = 2               # coarse-to-fine scales 2..0 (PatchMatch.h:59)
    max_image_size: int = 3200       # (PatchMatch.h:52)
    cost_max: float = 2.0            # NCC invalid cost (PatchMatch.cu:341)
    geom_cost_max: float = 3.0       # reprojection error clamp (PatchMatch.cu:619)
    geom_weight: float = 0.2         # geometric cost weight (PatchMatch.cu:687,886)
    num_mc_samples: int = 15         # Monte-Carlo view draws (PatchMatch.cu:856)
    prior_gamma: float = 0.5         # planar-prior score floor (PatchMatch.cu:926)
    prior_beta: float = 0.18         # cost->score temperature (PatchMatch.cu:932)
    prior_angle_sigma_deg: float = 5.0  # (PatchMatch.cu:929)
    prior_depth_sigma_frac: float = 1.0 / 64.0  # of depth range (PatchMatch.cu:927)
    refine_perturbation: float = 0.02   # ±2% depth / 0.02π normal (PatchMatch.cu:644)
    # reference's refinement always overwrites the prior-guided random sample
    # (missing `else`, PatchMatch.cu:660-663); True reproduces that behavior.
    legacy_prior_refinement: bool = True
    # rows per processing band; 0 = automatic (ops.propagation.auto_band_rows)
    band_rows: int = 0
    # Documented deviations of the JAX package, kept so both packages solve
    # the same problem (mpmvs_tpu/params.py:59-104 gives the reasons):
    # footprint cap — hypotheses whose projected window leaves a box of
    # ±footprint_cap_mult x (window radius) around the centre cost cost_max.
    footprint_cap_mult: float = 4.0
    # smooth tile-banded random depth draws instead of full-range ones
    coherent_random: bool = True
    random_band_frac: float = 1.0 / 32.0  # band width as a range fraction
    # candidates are scored at a disparity within ±disp_clamp_frac x range
    # of their source pixel's stored depth (adoption keeps the original)
    disp_clamp_frac: float = 1.0 / 16.0
    # init normals drawn within this cone around the anti-viewing ray
    init_normal_cone_deg: float = 60.0
    # NCC path of the incoherent fields (the init field, the random-depth
    # refinement trials 0 and 2): "auto" scores every field with
    # ops.ncc_cuda's K-stacked kernel; "sorted" sends those through
    # ops.ncc_sorted's bucket-sorted sample kernel (the JAX package's
    # "pallas_sorted"). Both compute the same costs.
    sampler: str = "auto"

    def __post_init__(self):
        if self.sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, got "
                             f"{self.sampler!r}")

    @property
    def ncc_taps(self) -> int:
        return self.ncc_taps_per_axis * self.ncc_taps_per_axis

    def effective_band_frac(self) -> float:
        """Band width for cold (random-init photometric) schedules: smoke
        schedules with fewer than 4 draw rounds fall back to full-range
        draws (the reference's semantics)."""
        rounds = (self.max_scale + 1) * self.max_iterations
        if rounds < 4:
            return 1.0
        return self.random_band_frac

    def cap_radius(self, scale: int) -> float:
        """Footprint-cap box half-width in px for one scale (0 = off). The
        per-scale growth is clamped at 2x, with a floor of twice the nominal
        window extent for scales above 2 (mpmvs_tpu/params.py:140-163)."""
        if self.footprint_cap_mult <= 0.0:
            return 0.0
        cap = self.footprint_cap_mult * 5.0 * min(2 ** scale, 2)
        if scale > 2:
            cap = max(cap, 2.0 * 5.0 * (2 ** scale))
        return cap

    def tap_offsets(self, scale: int):
        """Static window offsets for one scale: step 2*2^scale, 6 taps per
        axis at ±{0.5, 1.5, 2.5}*step (PatchMatch.cu:341-373). Returns a list
        of (dx, dy) ints."""
        step = 2 * (2 ** scale)
        radius = 5 * step // 2
        axis = list(range(-radius, radius + 1, step))
        if len(axis) != self.ncc_taps_per_axis:
            raise ValueError(f"tap axis {axis} does not have "
                             f"{self.ncc_taps_per_axis} taps")
        return [(dx, dy) for dx in axis for dy in axis]


@dataclasses.dataclass
class ConfigParams:
    """Pipeline configuration (the reference's config/config.yaml schema)."""

    input_folder: str = ""
    output_folder: str = ""
    geom_iterations: int = 2        # number of geometric passes over all views
    planar_prior: bool = True
    geom_planar_prior: bool = True
    sky_seg: bool = False
    use_dynamic_consistency: bool = True
    save_dmb: bool = False
    save_prior_dmb: bool = False
    save_cost_dmb: bool = False
    save_normal_dmb: bool = False
    max_source_images: int = 20
    max_image_size: int = 3200
    seed: int = 0
    # Extension key of the JAX package: the prior sub-run inside geometric
    # passes keeps the geometric term (False reproduces the reference).
    geom_prior_consistency: bool = False

    # Reference YAML keys (config/config.yaml:1-18, utility.cpp:8-35).
    _YAML_KEYS = {
        "Input-folder": "input_folder",
        "Output-folder": "output_folder",
        "Geometric consistency iterations": "geom_iterations",
        "Planer prior": "planar_prior",
        "Geometric consistency planer prior": "geom_planar_prior",
        "Sky segment": "sky_seg",
        "Use dynamic_consistency to fuse": "use_dynamic_consistency",
        "Save Dmb as JPG": "save_dmb",
        "Save Prior Dmb as JPG": "save_prior_dmb",
        "Save Cost Map": "save_cost_dmb",
        "Save Normal Map": "save_normal_dmb",
        "Max source images num": "max_source_images",
        "Max image size": "max_image_size",
        "Geometric prior consistency": "geom_prior_consistency",
    }

    @classmethod
    def from_yaml(cls, path: str) -> "ConfigParams":
        """Read the reference's config file: flat ``Key: value`` lines
        (:func:`parse_flat_yaml`, no PyYAML), keys by ``_YAML_KEYS`` or by
        field name; unknown keys are ignored."""
        with open(path) as f:
            raw = parse_flat_yaml(f.read())
        cfg = cls()
        for key, value in raw.items():
            attr = cls._YAML_KEYS.get(key, key if hasattr(cls, key) else None)
            if attr is None or not hasattr(cfg, attr):
                continue
            cur = getattr(cfg, attr)
            if isinstance(cur, bool):
                value = bool(int(value))
            elif isinstance(cur, int):
                value = int(value)
            setattr(cfg, attr, value)
        cfg.input_folder = cfg.input_folder.rstrip("/")
        cfg.output_folder = cfg.output_folder.rstrip("/")
        return cfg


_YAML_BOOL = {w: v for v, words in ((True, "yes true on"),
                                    (False, "no false off"))
              for word in words.split()
              for w in (word, word.capitalize(), word.upper())}
_YAML_NULL = ("", "~", "null", "Null", "NULL")
_YAML_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_YAML_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")


def _yaml_scalar(text: str):
    """One plain or quoted scalar as ``yaml.safe_load`` (YAML 1.1) reads
    it: a quoted string, null, a bool word, a decimal int, a float with a
    point, or else the plain string."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else \
            body.encode().decode("unicode_escape")
    if text in _YAML_NULL:
        return None
    if text in _YAML_BOOL:
        return _YAML_BOOL[text]
    if _YAML_INT.match(text):
        return int(text.replace("_", ""))
    if _YAML_FLOAT.match(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    return text


def parse_flat_yaml(text: str) -> dict:
    """The mapping of a flat YAML document of ``Key: value`` lines, the
    reference's config schema (config/config.yaml): directives (the
    ``%YAML:1.0`` of OpenCV's FileStorage), document markers, comments and
    blank lines are skipped; a value runs to the end of its line or to a
    `` #`` comment outside quotes. Nested blocks, flow collections and
    multi-line scalars are refused."""
    out = {}
    for n, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if (not stripped or stripped.startswith(("#", "%"))
                or stripped in ("---", "...")):
            continue
        if line[0].isspace() or stripped.startswith(("- ", "{", "[")):
            raise ValueError(f"line {n}: only flat 'Key: value' lines are "
                             f"read, got {line!r}")
        m = re.match(r"(\"[^\"]*\"|'[^']*'|[^:#]*?)\s*:(\s+(.*)|$)", stripped)
        if m is None:
            raise ValueError(f"line {n}: no 'Key: value' in {line!r}")
        key = _yaml_scalar(m.group(1).strip())
        value = (m.group(3) or "").strip()
        if value and value[0] not in "\"'":
            value = re.split(r"\s#", value, maxsplit=1)[0].rstrip()
        elif value:
            q = re.match(r"'(?:[^']|'')*'|\"(?:[^\"\\]|\\.)*\"", value)
            value = q.group(0) if q else value
        if value[:1] in ("{", "[", "|", ">", "&", "*", "!"):
            raise ValueError(f"line {n}: only plain and quoted scalars are "
                             f"read, got {value!r}")
        out[str(key)] = _yaml_scalar(value)
    return out
