"""Structured metrics + logging for render runs.

Reference: raw cout/cerr progress meters (Raytracer.h:107,223-224, SURVEY.md
section 5).  Here: a per-pass metric dict (photons/s, Mrays/s, hit points,
mean r2) and an append-only JSONL sink.
"""

from __future__ import annotations

import json
import logging
import time

logger = logging.getLogger("raytrace3_tpu")


class PassMeter:
    """Tracks throughput across SPPM passes."""

    def __init__(self, photons_per_pass: int, rays_per_pass: int,
                 jsonl_path: str | None = None):
        self.photons_per_pass = photons_per_pass
        self.rays_per_pass = rays_per_pass
        self.jsonl_path = jsonl_path
        self.t0 = time.perf_counter()
        self.passes = 0
        self.total_time = 0.0

    def start_pass(self):
        self._pass_t0 = time.perf_counter()

    def end_pass(self, extra: dict | None = None,
                 photons: float | None = None) -> dict:
        """``photons`` overrides the static per-pass estimate (photon
        regeneration emits a data-dependent count per pass)."""
        dt = time.perf_counter() - self._pass_t0
        self.passes += 1
        self.total_time += dt
        if photons is not None:
            self.photons_per_pass = photons  # last pass's actual count
        rec = {
            "pass": self.passes,
            "pass_seconds": dt,
            "photons_per_s": self.photons_per_pass / dt,
            "mrays_per_s": self.rays_per_pass / dt / 1e6,
            **(extra or {}),
        }
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        logger.info(
            "pass %d: %.2fs  %.3g photons/s  %.2f Mrays/s",
            self.passes, dt, rec["photons_per_s"], rec["mrays_per_s"],
        )
        return rec

    def summary(self) -> dict:
        t = max(self.total_time, 1e-9)
        return {
            "passes": self.passes,
            "total_seconds": t,
            "photons_per_s": self.passes * self.photons_per_pass / t,
            "mrays_per_s": self.passes * self.rays_per_pass / t / 1e6,
        }
