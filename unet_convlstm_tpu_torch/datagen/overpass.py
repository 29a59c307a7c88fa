"""Satellite overpass CSV parsing — the camera/sun geometry contract
(the port's own copy of unet_convlstm_tpu/datagen/overpass.py, numpy only).

Schema (reference data/Dor_2satellites_overpass.csv:1; 12 UTC times × N
satellites per file): columns ``utc time``, ``sun zenith [deg]``,
``sun azimuth [deg]``, ``sat zenith [deg]``, ``sat azimuth [deg]``,
``scattering angle [deg]``, ``sat ENU coordinates [km]`` (a "[x, y, z]"
string), ``lookat ENU coordinates [km]``.

Two consumers with two conventions (both preserved):

* Renderer (reference mitsuba3/render.py:64-83, 102-117): camera origin is
  (ENU[1], ENU[0], ENU[2]) km — x/y swapped — target [0, 0, z_center·2.5],
  up [1, 0, 0].
* Velocity-map caster (reference preprocessing/build_WVU_maps.py:11-47):
  camera position is (-ENU[1], ENU[0], ENU[2])·1000 m, look-at forced to
  [0, 0, 1500] m.

Implemented with the csv stdlib (no pandas dependency on the hot path).
"""

from __future__ import annotations

import ast
import csv
import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class OverpassView:
    utc_time: float
    sun_zenith: float
    sun_azimuth: float
    sat_zenith: float
    sat_azimuth: float
    scattering_angle: float
    sat_enu_km: np.ndarray      # raw [x, y, z] from the CSV
    lookat_enu_km: np.ndarray

    def caster_camera_m(self, lookat_m=(0.0, 0.0, 1500.0)
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """ENU→world transform of the velocity-map pipeline
        (build_WVU_maps.py:29-41)."""
        e = self.sat_enu_km
        pos = np.array([-e[1], e[0], e[2]], np.float64) * 1000.0
        return pos, np.asarray(lookat_m, np.float64)

    def renderer_camera_km(self, target_z_km: float
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Origin/target/up of the radiance renderer (render.py:108-117)."""
        e = self.sat_enu_km
        origin = np.array([e[1], e[0], e[2]], np.float64)
        target = np.array([0.0, 0.0, target_z_km], np.float64)
        up = np.array([1.0, 0.0, 0.0], np.float64)
        return origin, target, up


def read_overpass_csv(path: str) -> List[OverpassView]:
    views: List[OverpassView] = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            views.append(OverpassView(
                utc_time=float(row["utc time"]),
                sun_zenith=float(row["sun zenith [deg]"]),
                sun_azimuth=float(row["sun azimuth [deg]"]),
                sat_zenith=float(row["sat zenith [deg]"]),
                sat_azimuth=float(row["sat azimuth [deg]"]),
                scattering_angle=float(row["scattering angle [deg]"]),
                sat_enu_km=np.asarray(
                    ast.literal_eval(row["sat ENU coordinates [km]"]),
                    np.float64),
                lookat_enu_km=np.asarray(
                    ast.literal_eval(row["lookat ENU coordinates [km]"]),
                    np.float64),
            ))
    return views


def camera_schedule(views: List[OverpassView]
                    ) -> Tuple[List[float], Dict[float, List[OverpassView]]]:
    """Group views by UTC time (sorted) — build_WVU_maps.py:18-47."""
    schedule: Dict[float, List[OverpassView]] = {}
    for v in views:
        schedule.setdefault(v.utc_time, []).append(v)
    return sorted(schedule), schedule


def enumerate_patch_folders(input_root: str, start=None, end=None
                            ) -> List[Tuple[int, str]]:
    """Numerically-named patch folders under ``input_root`` with optional
    [start, end] numeric bounds, as (position, folder) pairs. The position
    is the folder's index in the FULL sorted list — NOT the filtered one —
    so the cyclic CSV-time assignment of a bounded/resumed run renders
    with the same geometry as a full run (reference render_all.py:80-90
    keeps original_start_idx for the same reason). Single source for the
    serial and batched stage-B/C drivers."""
    # NUMERIC sort: the reference sorts folders numerically in stage A
    # (preprocessing.py:106) and stage D (build_sequences.py:52); its
    # stage-B plain sorted() only agrees because names are zero-padded.
    # key=int keeps all stages consistent on unpadded trees too (a
    # lexicographic '10' < '2' here would render folder 10 with folder
    # 2's cyclic timestamp — silently scrambled camera/sun geometry).
    all_folders = sorted((f for f in os.listdir(input_root)
                          if os.path.isdir(os.path.join(input_root, f))
                          and f.isdigit()), key=int)
    return [(i, f) for i, f in enumerate(all_folders)
            if (start is None or int(f) >= start)
            and (end is None or int(f) <= end)]


def synthesize_overpass_csv(path: str, n_times: int = 12,
                            n_satellites: int = 2,
                            time_step_s: float = 20.0,
                            altitude_km: float = 580.0,
                            along_track_speed_km_s: float = 7.5,
                            sun_zenith0: float = 145.0,
                            sun_azimuth0: float = 32.7) -> str:
    """Generate an overpass CSV with the reference schema (the reference
    ships measured CSVs as data assets, data/Dor_2satellites_overpass.csv —
    this synthesizes a physically plausible constellation pass: satellites
    trail each other along-track at LEO altitude, geometry advancing per
    time step)."""
    rows = []
    for ti in range(n_times):
        t = ti * time_step_s
        for s in range(n_satellites):
            # along-track offset per satellite; track advances with time
            along = -900.0 + along_track_speed_km_s * t + 150.0 * s
            cross = 150.0 + 5.0 * s
            pos = np.array([along, cross, altitude_km])
            ground = np.linalg.norm(pos[:2])
            sat_zenith = np.degrees(np.arctan2(ground, altitude_km))
            sat_azimuth = (np.degrees(np.arctan2(cross, along)) + 360) % 360
            sun_ze = sun_zenith0 - 0.002 * t
            sun_az = sun_azimuth0 + 0.005 * t
            sun = sun_direction(sun_ze, sun_az)
            view = -pos / np.linalg.norm(pos)
            scattering = float(np.degrees(np.arccos(
                np.clip(np.dot(sun, view), -1, 1))))
            rows.append((t, sun_ze, sun_az, sat_zenith, sat_azimuth,
                         scattering, pos))
    with open(path, "w") as f:
        f.write("utc time,sun zenith [deg],sun azimuth [deg],"
                "sat zenith [deg],sat azimuth [deg],"
                "scattering angle [deg],sat ENU coordinates [km],"
                "lookat ENU coordinates [km]\n")
        for (t, sz, sa, vz, va, sc, pos) in rows:
            f.write(f"{t:g},{sz:.7f},{sa:.7f},{vz:.7f},{va:.7f},{sc:.7f},"
                    f'"[{pos[0]:.6f}, {pos[1]:.6f}, {pos[2]:.6f}]",'
                    f'"[0, 0, 0]"\n')
    return path


def sun_direction(zenith_deg: float, azimuth_deg: float) -> np.ndarray:
    """Spherical → cartesian propagation direction of sunlight, exactly the
    reference's formula (render.py:204-211):
    (-sin·sin, -sin·cos, +cos); the CSV's zenith angles exceed 90°, so the
    z component comes out negative (downward travel)."""
    az = np.deg2rad(azimuth_deg)
    ze = np.deg2rad(zenith_deg)
    return np.array([-np.sin(ze) * np.sin(az),
                     -np.sin(ze) * np.cos(az),
                     np.cos(ze)], np.float64)


def legacy_sun_direction(zenith_deg: float, azimuth_deg: float
                         ) -> np.ndarray:
    """The legacy udi renderer's alternate sun formula
    (render_from_udi_class.py:213-217):
    [-sin(az), cos(az), -1/tan(180° - zenith)], normalized (Mitsuba
    normalizes directional-emitter directions). Differs from the current
    formula in both the horizontal sign convention and the zenith
    parameterization — kept for byte-compatible re-rendering of legacy
    datasets."""
    az = np.deg2rad(azimuth_deg)
    z = -1.0 / np.tan(np.deg2rad(180.0 - zenith_deg))
    d = np.array([-np.sin(az), np.cos(az), z], np.float64)
    return d / np.linalg.norm(d)
