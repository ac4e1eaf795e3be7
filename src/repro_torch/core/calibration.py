"""Calibration constants and hardware reference curves (paper §IV, Table III).

Latency constants come from the paper's Table III (calibrated against an
Intel Xeon 6416H + Montage MXC CXL 2.0 memory expander platform plus prior
measurement studies [5, 26, 32, 40, 44, 49, 55]).

``REFERENCE_HW`` holds the hardware-measured values the paper validates
against (digitized from Fig. 7/8 and cross-checked against the public CXL
measurement literature, e.g. Sun et al., MICRO'23).  The validation benchmark
replays the MLC-style experiments in the simulator and reports error against
these references, mirroring the paper's 0.1–10 % bandwidth and ≤12 %
loaded-latency error claims.

The PyTorch port keeps its own copy of these plain constants (identical to
``repro.core.calibration``) so that it never imports the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

PS = 1
NS = 1_000


@dataclass(frozen=True)
class TableIII:
    requester_process_ps: int = 10 * NS
    cache_access_ps: int = 12 * NS
    device_controller_ps: int = 40 * NS
    pcie_port_delay_ps: int = 25 * NS
    bus_time_ps: int = 1 * NS
    switching_ps: int = 20 * NS


CAL = TableIII()

# PCIe 5.0 x16: 32 GT/s * 16 lanes / 8 b/B * 128/130 encoding ~= 63 GB/s/dir.
PCIE5_X16_MBPS = 63_000
# PCIe 6.0 x16 (CXL 3.1 target): 64 GT/s, PAM4 + FLIT -> ~121 GB/s/dir.
PCIE6_X16_MBPS = 121_000
# Pre-flit-framing lane rates for flit-mode links: core.link_layer models
# the flit CRC/FEC overhead explicitly, so flit links are configured with
# the rate *after* line encoding but *before* flit framing.  PCIe 6.0 PAM4
# uses no 128b/130b encoding (64 GT/s * 16 / 8 b/B); PCIe 5.0 is NRZ with
# 128b/130b, which link_layer does not model, so its encoding stays in.
PCIE6_X16_RAW_MBPS = 128_000
PCIE5_X16_RAW_MBPS = 63_015  # 32 GT/s * 16 / 8 b/B * 128/130

# ---------------------------------------------------------------------------
# FLIT link-layer geometry (Das Sharma, arXiv 2306.11227, Fig. 5/9)
# ---------------------------------------------------------------------------
# PCIe 6.0 / CXL 3.x 256 B flit: 236 B TLP + 6 B DLLP + 8 B CRC + 6 B FEC.
FLIT256_SIZE_B = 256
FLIT256_PAYLOAD_B = 236
# PCIe 5 / CXL 2.0 68 B flit: four 16 B slots (64 B) + 2 B CRC + 2 B proto ID.
FLIT68_SIZE_B = 68
FLIT68_PAYLOAD_B = 64
# Lightweight 3-way interleaved FEC decode latency (~2 ns per hop) and the
# link-level Go-Back-N replay / credit-return loop latency.
FEC_LATENCY_PS = 2 * NS
CRC_REPLAY_RTT_PS = 100 * NS
# Credit-return DLLP: 6 B of DLLP payload + framing, modeled as 8 logical
# bytes (one flit on the wire once quantized) per credit-return window.
CREDIT_DLLP_B = 8
# Link retraining (recovery) interval: when CRC replays storm past the retry
# threshold the link drops to Recovery and re-equalizes — a microsecond-scale
# stall during which the channel grants nothing (Das Sharma, arXiv 2306.11227
# puts PCIe recovery in the us range; lane margining studies measure 1-10 us).
LINK_RETRAIN_PS = 1_000 * NS
# One DDR5-4800 DIMM ~ 38.4 GB/s; the MXC expander and each NUMA node carry 4.
DDR5_DIMM_MBPS = 38_400
EXPANDER_MBPS = 4 * DDR5_DIMM_MBPS

# DRAM service timing for the banked endpoint model (DRAMsim3 stand-in).
DRAM_ROW_HIT_PS = 15 * NS
DRAM_ROW_MISS_PS = 40 * NS

# ---------------------------------------------------------------------------
# Hardware reference points (paper Fig. 7/8; CXL literature cross-check)
# ---------------------------------------------------------------------------

REFERENCE_HW = {
    # idle (unloaded) read latency, ns
    "idle_latency_ns": {
        "local_dram": 108.0,
        "remote_numa_dram": 191.0,
        "cxl_mxc": 256.0,
    },
    # peak bandwidth vs read:write ratio, GB/s (Fig. 7 right; CXL rises with
    # mixing because PCIe is full duplex; DRAM platforms *fall* as writes mix
    # in — captured by the half-duplex/turnaround DDR bus model)
    "peak_bw_GBs": {
        #            R:W = 1:0    3:1    2:1    1:1
        "cxl_mxc":      [26.0,  33.0,  36.0,  42.0],
        "local_dram":   [118.0, 108.0, 104.0, 98.0],
        "remote_numa_dram": [50.0, 47.0, 45.0, 43.0],
    },
    "rw_ratios": [(1, 0), (3, 1), (2, 1), (1, 1)],
    # loaded-latency anchor points for CXL reads: (bandwidth GB/s, latency ns)
    "loaded_latency_cxl_read": [
        (2.0, 258.0), (8.0, 266.0), (16.0, 290.0), (22.0, 340.0), (25.0, 430.0),
    ],
    # SPEC CPU2017 execution-time overhead of CXL memory vs local DRAM
    # (paper Table IV, hardware row)
    "spec_overhead": {"gcc": 0.180, "mcf": 0.242},
    # the paper's own accuracy statements, used as acceptance gates
    "paper_error_bands": {
        "bandwidth_rel_err_max": 0.10,
        "loaded_latency_rel_err_max": 0.12,
        "loaded_latency_rel_err_avg": 0.043,
    },
}

# Paper Table IV: simulated CXL execution-time overheads per platform.
TABLE_IV = {
    "CXL Hardware":  {"gcc": 0.180, "mcf": 0.242},
    "ESF standalone": {"gcc": 0.187, "mcf": 0.298},
    "gem5-ESF":      {"gcc": 0.156, "mcf": 0.198},
    "NUMA emulation": {"gcc": 0.200, "mcf": 0.150},
    "gem5-garnet":   {"gcc": 0.122, "mcf": 0.152},
}

# Paper Fig. 10 normalized system bandwidth targets (claim F1), scale->value.
FIG10_TARGETS = {
    "chain": "flat ~1x port bandwidth",
    "tree": "flat ~1x port bandwidth",
    "ring": "~2x port bandwidth at scale",
    "spine_leaf": "~N/2 x port bandwidth",
    "fully_connected": "~N x port bandwidth",
}

# Paper Fig. 18/19 trace-replay ratios vs chain (claim F7).
FIG18_TARGETS = {"ring": 1.72, "spine_leaf": 2.27, "fully_connected": 3.63}
FIG19_TARGETS = {"ring": 0.57, "spine_leaf": 0.44, "fully_connected": 0.28}

# Paper Fig. 14 (claim F4): LIFO vs FIFO.
FIG14_TARGETS = {"bandwidth": 1.05, "latency": 0.85, "invalidation": 0.84}

# Fig. 20b: +0.1 mix degree ~ +9% bandwidth on full-duplex links.
FIG20_SLOPE_PER_01 = 0.09
