"""Cloud microphysics → optical properties (the port's own copy of
unet_convlstm_tpu/datagen/microphysics.py).

Behavioral parity with reference ``mitsuba3/calc_beta.py:4-27``
(process_cloud_vars), written from the physics:

inputs  QN [g/kg] liquid-water mixing ratio, volume [Z, X, Y]
        NC [cm⁻³] droplet number concentration, volume [Z, X, Y]
        T  [K]    absolute temperature, volume [Z, X, Y]
        p  [mb]   pressure profile over Z (1-D, length Z)

chain   ideal-gas air density  ρ_air = (100·p · m_air) / (kB · T)  [kg/m³]
        liquid water content   LWC   = QN · ρ_air                  [g/m³]
        mean droplet volume    V     = (LWC / NC[m⁻³]) / ρ_w[g/m³] [m³]
        effective radius       Reff  = (3V / 4π)^{1/3}             [m]
        extinction             β_ext = 3·LWC / (2·ρ_w·Reff)        [m⁻¹]

returns (LWC [g/m³], Reff [µm], beta_ext [m⁻¹]) — the same epsilon guards
(1e-15 on NC and on the β denominator) as the reference.

Takes numpy arrays (host math, as stage A runs it) or torch tensors (on
their own device, in the dtype of ``QN``) and returns the same kind.
"""

from __future__ import annotations

import numpy as np
import torch

K_B = 1.380649e-23        # Boltzmann [J/K]
M_AIR = 4.81e-26          # mean mass of an air molecule [kg]
RHO_WATER_G_M3 = 1.0e6    # liquid water density [g/m³]


def process_cloud_vars(QN, NC, T, p):
    """See module docstring. numpy in, numpy out; torch in, torch out."""
    if isinstance(QN, torch.Tensor):
        def asarray(a):
            return torch.as_tensor(a, dtype=QN.dtype, device=QN.device)
        ones_like = torch.ones_like
    else:
        asarray, ones_like = np.asarray, np.ones_like
    p_pa = asarray(p) * 100.0                          # mb → Pa
    T = asarray(T)
    P = p_pa[:, None, None] * ones_like(T)
    rho_air = (P * M_AIR) / (K_B * T)                  # [kg/m³]
    LWC = asarray(QN) * rho_air                        # [g/m³]

    NC_m3 = asarray(NC) * 1.0e6                        # cm⁻³ → m⁻³
    droplet_vol = (LWC / (NC_m3 + 1e-15)) / RHO_WATER_G_M3   # [m³]
    reff_m = ((3.0 * droplet_vol) / (4.0 * np.pi)) ** (1.0 / 3.0)
    beta_ext = (3.0 * LWC) / (2.0 * RHO_WATER_G_M3 * reff_m + 1e-15)
    return LWC, reff_m * 1.0e6, beta_ext
