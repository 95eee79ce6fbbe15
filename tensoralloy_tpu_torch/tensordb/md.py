"""MD helpers (port of `tensoralloy_tpu/tensordb/md.py`; reference
`tensordb/md.py`)."""


def recommend_md_timestep(temperature: float, mass_amu: float,
                          volume_per_atom: float,
                          factor: float = 80.0) -> float:
    """Recommend an AIMD timestep (fs) from the thermal velocity and
    the per-atom volume: t = 2 r_ws / v_thermal / factor."""
    kb = 8.617330337217213e-05          # eV/K
    v2 = 3.0 * temperature * kb / mass_amu
    # eV/amu -> (A/10fs)^2: 1 eV/amu = 1.602e-19/1.661e-27 m^2/s^2
    v2 = v2 * 1.60217662 / 1.66053906660 / 100.0
    v = v2 ** 0.5                        # A / 10 fs
    radius = (volume_per_atom * 3.0 / (4.0 * 3.14159265359)) ** (1 / 3)
    return 2.0 * radius / v / factor
