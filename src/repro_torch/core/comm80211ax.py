"""IEEE 802.11ax airtime/energy model for the FL model-update upload.

Port of :mod:`repro.core.comm80211ax`. A single-user HE transmission with
RTS/CTS protection and a fixed contention window (paper Table I); ``T_tx``
is the airtime to upload the ``S_w``-byte model update and
``E_tx = P_tx * T_tx`` (paper eq. 2).

* :func:`airtime_model` — the scalar closed form in pure Python ``math``,
  copied verbatim from the reference (its test oracle).
* :func:`airtime_model_batched` — the same model over per-node MCS and/or
  payload tensors in ``torch.float64``, for channel-heterogeneous fleets.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import as_float64, resolve_device

__all__ = ["CommParams", "airtime_model", "airtime_model_batched",
           "PAPER_COMM"]


@dataclasses.dataclass(frozen=True)
class CommParams:
    """Table I — Communication (IEEE 802.11ax), 20 MHz, 1 spatial stream."""

    tx_power_dbm: float = 9.0          # P_tx for edge devices
    sigma_legacy_us: float = 4.0       # legacy OFDM symbol duration
    n_subcarriers: int = 234           # 20 MHz RU
    n_spatial_streams: int = 1
    t_empty_slot_us: float = 9.0
    t_sifs_us: float = 16.0
    t_difs_us: float = 34.0
    t_phy_preamble_us: float = 20.0    # legacy preamble
    t_he_su_us: float = 100.0          # HE single-user field duration
    l_ofdm_symbol_bits: int = 24       # L_s, legacy rate for control frames
    l_rts_bits: int = 160
    l_cts_bits: int = 112
    l_ack_bits: int = 240
    l_service_bits: int = 16
    l_mac_header_bits: int = 320
    contention_window: int = 15        # CW (fixed)
    bits_per_symbol_per_sc: float = 10.0  # 1024-QAM 5/6 → 8.33; MCS settable
    sigma_he_us: float = 13.6          # HE OFDM symbol (incl. 0.8 us GI)
    a_mpdu_max_bits: int = 65536 * 8   # max A-MPDU aggregate size


PAPER_COMM = CommParams()


def _control_frame_us(p: CommParams, l_bits: int) -> float:
    """Legacy-rate control frame airtime (preamble + ceil(bits/24) symbols)."""
    n_sym = math.ceil((l_bits + p.l_service_bits) / p.l_ofdm_symbol_bits)
    return p.t_phy_preamble_us + n_sym * p.sigma_legacy_us


def airtime_model(
    payload_bytes: float,
    params: CommParams = PAPER_COMM,
) -> dict:
    """Airtime to upload ``payload_bytes`` over 802.11ax single-user HE.

    The payload (the 44.73 MB ResNet-18 update in the paper) is fragmented
    into maximum-size A-MPDUs; each transmission pays
    DIFS + backoff + RTS/CTS + HE preamble + data symbols + SIFS + ACK.

    Returns dict with ``t_tx_s`` (total airtime, seconds), ``t_data_s``,
    ``t_overhead_s``, ``n_ampdu``, ``goodput_mbps``.
    """
    p = params
    bits_total = payload_bytes * 8.0
    data_bits_per_symbol = (
        p.n_subcarriers * p.n_spatial_streams * p.bits_per_symbol_per_sc)

    mpdu_bits = p.a_mpdu_max_bits
    n_ampdu = max(1, math.ceil(bits_total / mpdu_bits))

    t_rts = _control_frame_us(p, p.l_rts_bits)
    t_cts = _control_frame_us(p, p.l_cts_bits)
    t_ack = _control_frame_us(p, p.l_ack_bits)
    mean_backoff_us = (p.contention_window / 2.0) * p.t_empty_slot_us

    per_txop_overhead_us = (
        p.t_difs_us + mean_backoff_us
        + t_rts + p.t_sifs_us + t_cts + p.t_sifs_us
        + p.t_phy_preamble_us + p.t_he_su_us
        + p.t_sifs_us + t_ack)

    def data_airtime_us(bits: float) -> float:
        n_sym = math.ceil(
            (bits + p.l_mac_header_bits + p.l_service_bits) / data_bits_per_symbol)
        return n_sym * p.sigma_he_us

    full, rem = divmod(bits_total, mpdu_bits)
    t_data_us = full * data_airtime_us(mpdu_bits)
    if rem > 0:
        t_data_us += data_airtime_us(rem)
    t_overhead_us = n_ampdu * per_txop_overhead_us
    t_total_us = t_data_us + t_overhead_us

    tx_power_w = 10.0 ** (p.tx_power_dbm / 10.0) * 1e-3
    t_total_s = t_total_us * 1e-6
    return {
        "t_tx_s": t_total_s,
        "t_data_s": t_data_us * 1e-6,
        "t_overhead_s": t_overhead_us * 1e-6,
        "n_ampdu": n_ampdu,
        "goodput_mbps": (bits_total / t_total_us) if t_total_us else 0.0,
        "tx_power_w": tx_power_w,
        "e_tx_wh": tx_power_w * t_total_s / 3600.0,
    }


def airtime_model_batched(
    payload_bytes,
    bits_per_symbol_per_sc=None,
    params: CommParams = PAPER_COMM,
    *,
    device: str | torch.device = "cuda",
) -> dict:
    """Vectorized :func:`airtime_model`: per-node MCS/payload → airtimes.

    ``bits_per_symbol_per_sc`` (the MCS knob; ``None`` takes
    ``params``'s) broadcasts against ``payload_bytes``. Every output is a
    float64 tensor of the broadcast shape on ``device``, except
    ``tx_power_w``, a Python float (the fleet shares P_tx).

    As in the reference, the float ``divmod`` fragmentation becomes floor
    division and remainder with the zero-remainder data frame masked out
    (``data_airtime(0)`` would still charge a MAC-header symbol), and the
    goodput division has a safe denominator for a zero airtime.
    """
    p = params
    dev = resolve_device(device)
    payload = as_float64(payload_bytes, dev)
    bps = as_float64(p.bits_per_symbol_per_sc if bits_per_symbol_per_sc is None
                     else bits_per_symbol_per_sc, dev)
    payload, bps = torch.broadcast_tensors(payload, bps)

    bits_total = payload * 8.0
    data_bits_per_symbol = p.n_subcarriers * p.n_spatial_streams * bps

    mpdu_bits = float(p.a_mpdu_max_bits)
    n_ampdu = torch.clamp(torch.ceil(bits_total / mpdu_bits), min=1.0)

    # control frames ride at the legacy rate: the scalar oracle's floats
    t_rts = _control_frame_us(p, p.l_rts_bits)
    t_cts = _control_frame_us(p, p.l_cts_bits)
    t_ack = _control_frame_us(p, p.l_ack_bits)
    mean_backoff_us = (p.contention_window / 2.0) * p.t_empty_slot_us
    per_txop_overhead_us = (
        p.t_difs_us + mean_backoff_us
        + t_rts + p.t_sifs_us + t_cts + p.t_sifs_us
        + p.t_phy_preamble_us + p.t_he_su_us
        + p.t_sifs_us + t_ack)

    def data_airtime_us(bits):
        n_sym = torch.ceil(
            (bits + p.l_mac_header_bits + p.l_service_bits)
            / data_bits_per_symbol)
        return n_sym * p.sigma_he_us

    full = torch.div(bits_total, mpdu_bits, rounding_mode="floor")
    rem = torch.remainder(bits_total, mpdu_bits)
    t_data_us = (full * data_airtime_us(torch.full_like(bits_total, mpdu_bits))
                 + torch.where(rem > 0.0, data_airtime_us(rem), 0.0))
    t_overhead_us = n_ampdu * per_txop_overhead_us
    t_total_us = t_data_us + t_overhead_us

    tx_power_w = 10.0 ** (p.tx_power_dbm / 10.0) * 1e-3
    t_total_s = t_total_us * 1e-6
    safe_t = torch.where(t_total_us > 0.0, t_total_us, 1.0)
    return {
        "t_tx_s": t_total_s,
        "t_data_s": t_data_us * 1e-6,
        "t_overhead_s": t_overhead_us * 1e-6,
        "n_ampdu": n_ampdu,
        "goodput_mbps": torch.where(t_total_us > 0.0, bits_total / safe_t,
                                    0.0),
        "tx_power_w": tx_power_w,
        "e_tx_wh": tx_power_w * t_total_s / 3600.0,
    }
