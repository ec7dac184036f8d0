"""The debug-checks frame (``--debug-checks``): out-of-range indices
reported per frame.

Counterpart of ``transmission_renderer_tpu/render/checks.py``. The
reference wraps its frame in ``jax.experimental.checkify`` with index
checks, because XLA clamps an out-of-range gather index silently and a
sizing bug then renders wrong pixels instead of failing. PyTorch has no
checkify, and it needs none for most of the port: its own indexing
raises on an out-of-range index (a device-side assert on the card). What
the checks add are the places where the port clamps an index on purpose,
as XLA does, and kernel 6's own reads:

- ``index(idx, bound, site, used)`` is the one helper those places call.
  With checks off it returns ``idx`` as it is and costs one test of a
  module global: no tensor work and no host sync. Under checks it counts
  the lanes of ``used`` whose index lies outside [0, bound) in a device
  counter for ``site`` and returns the index clamped into range (what
  XLA reads there).
- kernel 6 (csrc/raster_vis.cu) takes its checked instantiation under
  checks: it tests every global index it reads against its bound, and on
  a bad one sets a bit of an error word in a small device buffer and
  does not read (``report_word``).

The counters and words are read once per frame, in one transfer, and
each site that saw an out-of-range index prints one line holding
``out-of-bounds``. A clean frame prints nothing and is bit-equal to the
unchecked frame.

NaN checks are not part of this mode, as in the reference: masked-out
lanes compute NaN before their select by design; ``--check-nan`` tests
the final image.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys

import torch

# The frame's checks while a checked frame runs (None: checks are off).
_ACTIVE: _Checks | None = None


class _Checks:
    """Device-side out-of-range counts of one checked frame, by site, and
    kernel error words with the names of their bits."""

    def __init__(self):
        self.counts: dict = {}  # site -> int64 [] tensor
        self.words: list = []  # (int32 [1] tensor, {bit: site})

    def count(self, site: str, bad: torch.Tensor) -> None:
        n = bad.sum()
        self.counts[site] = self.counts[site] + n if site in self.counts else n

    def read(self) -> list:
        """[(site, count)] of the sites that saw an out-of-range index: one
        host read of every counter and word."""
        sites = list(self.counts)
        vals = [self.counts[s].to(torch.int64).reshape(1).cpu() for s in sites]
        vals += [w.to(torch.int64).reshape(1).cpu() for w, _ in self.words]
        flat = torch.cat(vals).tolist() if vals else []
        out = [(s, n) for s, n in zip(sites, flat) if n]
        for (_, bits), word in zip(self.words, flat[len(sites):]):
            out += [(site, None) for bit, site in bits.items() if word >> bit & 1]
        return out


def active() -> bool:
    """Whether a checked frame is running."""
    return _ACTIVE is not None


def index(idx: torch.Tensor, bound: int, site: str,
          used: torch.Tensor | None = None) -> torch.Tensor:
    """An index at a site where the port clamps on purpose, as XLA clamps
    an out-of-range gather: ``idx`` itself with checks off; under checks
    the lanes (of ``used``) outside [0, bound) are counted for ``site``
    and the index comes back clamped into range."""
    if _ACTIVE is None:
        return idx
    bad = (idx < 0) | (idx >= bound)
    _ACTIVE.count(site, bad if used is None else bad & used)
    return torch.clamp(idx, 0, max(bound - 1, 0))


def report_word(word: torch.Tensor, bits: dict) -> None:
    """Register a kernel's error word (int32 [1] on the device; bit b set:
    an out-of-range index at ``bits[b]``), read at the end of the frame."""
    if _ACTIVE is not None:
        _ACTIVE.words.append((word, bits))


@contextlib.contextmanager
def collect():
    """Run the block with the checks on -> a list that receives, when the
    block ends, (site, count) for each site that saw an out-of-range
    index (count None for a kernel's error word), from one host read."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("checks are already on")
    checks, found = _Checks(), []
    _ACTIVE = checks
    try:
        yield found
    finally:
        _ACTIVE = None
    found += checks.read()


def report_line(site: str, count) -> str:
    """The line a checked frame prints for a site."""
    what = f"{count} out-of-bounds indices" if count is not None else "an out-of-bounds index"
    return f"CHECKS: {what} at {site}"


def checked_frame_fn(*, config, flags, bvh=None, out=sys.stderr):
    """``render(scene, dl, params, lights)`` -> the frame of
    ``render_frame(..., config, flags)`` with the index checks on; every
    site that read an out-of-range index prints one line per frame to
    ``out``.

    Forces the visibility-buffer branch (``use_pallas_raster=False``), as
    the reference does. The reference also forces
    ``static_raster_trips``, because checkify cannot instrument its
    batched while-loops; the port keeps the flag for the same config, but
    it changes nothing here: kernel 6 and its plain version walk each
    tile's exact counts either way. Ray-traced shadows are refused, as in
    the reference (its BVH walk is a batched while-loop)."""
    if bvh is not None or config.ray_traced_shadows:
        raise ValueError("--debug-checks does not support the RT path "
                         "(batched while-loop traversal)")
    from transmission_renderer_tpu_torch.render.frame import render_frame

    config = dataclasses.replace(config, use_pallas_raster=False, static_raster_trips=True)

    def render(scene, dl, params, lights):
        with collect() as found:
            img = render_frame(scene, dl, params, lights, config, flags)
        for site, count in found:
            print(report_line(site, count), file=out)
        return img

    return render
