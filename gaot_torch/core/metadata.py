"""Dataset metadata registry (the port's own copy of
``gaot_tpu/core/metadata.py``, so the port imports nothing of the JAX
package).

Carries the same dataset descriptors as the reference registry
(src/datasets/dataset.py:7-461): per-dataset variable groups, domains,
active/chunked variables, and the global statistics used by the evaluation
metric. Values are data, not code, and must match the reference exactly for
metric parity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Literal, Optional, Sequence, Tuple, Union


@dataclass(frozen=True)
class Metadata:
    periodic: bool
    group_u: Optional[str]
    group_c: Optional[str]
    group_x: Optional[str]
    type: Literal["poseidon", "rigno", "gaot"]
    fix_x: bool
    domain_x: Tuple[Sequence[float], Sequence[float]]
    domain_t: Optional[Tuple[float, float]]
    active_variables: Sequence[int]
    chunked_variables: Sequence[int]
    num_variable_chunks: int
    signed: Dict[str, Union[bool, Sequence[bool], None]]
    names: Dict[str, Optional[Sequence[str]]]
    global_mean: Sequence[float]
    global_std: Sequence[float]


_ACTIVE_NS = [0, 1]
_ACTIVE_CE = [0, 1, 2, 3]
_ACTIVE_RD = [0]
_ACTIVE_WE = [0]
_ACTIVE_PE = [0]

_CHUNK_NS = [0, 0]
_CHUNK_CE = [0, 1, 1, 2, 3]
_CHUNK_RD = [0]
_CHUNK_WE = [0]
_CHUNK_PE = [0]

_SIGNED_NS = {"u": [True, True], "c": None}
_SIGNED_CE = {"u": [False, True, True, False, False], "c": None}
_SIGNED_RD = {"u": [True], "c": None}
_SIGNED_WE = {"u": [True], "c": [False]}
_SIGNED_PE = {"u": [True], "c": [True]}

_NAMES_NS = {"u": ["$v_x$", "$v_y$"], "c": None}
_NAMES_CE = {"u": ["$\\rho$", "$v_x$", "$v_y$", "$p$"], "c": None}
_NAMES_RD = {"u": ["$u$"], "c": None}
_NAMES_WE = {"u": ["$u$"], "c": ["$c$"]}
_NAMES_PE = {"u": ["$u$"], "c": ["$f$"]}


def _airfoil(domain, mean, std) -> Metadata:
    """Steady-Euler airfoil family (vx mode)."""
    return Metadata(
        periodic=False, group_u="u", group_c="c", group_x="x", type="gaot",
        domain_x=domain, domain_t=None, fix_x=False,
        active_variables=[0], chunked_variables=[0], num_variable_chunks=1,
        signed={"u": [False], "c": [False, False, False]},
        names={"u": ["$\\rho$"], "c": ["Mach", "AOA", "SDF"]},
        global_mean=mean, global_std=std,
    )


def _ce(mtype, p_mean) -> Metadata:
    """Compressible-flow family: [density, vx, vy, pressure]."""
    return Metadata(
        periodic=True, group_u="u", group_c=None, group_x="x", type=mtype,
        domain_x=([0, 0], [1, 1]), domain_t=(0, 1), fix_x=True,
        active_variables=_ACTIVE_CE, chunked_variables=_CHUNK_CE,
        num_variable_chunks=len(set(_CHUNK_CE)),
        signed=_SIGNED_CE, names=_NAMES_CE,
        global_mean=[0.80, 0.0, 0.0, p_mean],
        global_std=[0.31, 0.391, 0.356, 0.185],
    )


def _ns(mtype) -> Metadata:
    """Incompressible-fluids family: [vx, vy]."""
    return Metadata(
        periodic=True, group_u="u", group_c=None, group_x="x", type=mtype,
        domain_x=([0, 0], [1, 1]), domain_t=(0, 1), fix_x=True,
        active_variables=_ACTIVE_NS, chunked_variables=_CHUNK_NS,
        num_variable_chunks=len(set(_CHUNK_NS)),
        signed=_SIGNED_NS, names=_NAMES_NS,
        global_mean=[0.0, 0.0], global_std=[0.391, 0.356],
    )


DATASET_METADATA: Dict[str, Metadata] = {
    # --- steady Euler airfoils (variable coordinates) ---
    "compressible_flow/naca2412": _airfoil(
        ([-1, -1.5], [2.5, 2]), [0.96086993], [0.18490477]),
    "compressible_flow/naca0012": _airfoil(
        ([-1, -1.5], [2.5, 2]), [0.96999054], [0.17089098]),
    "compressible_flow/rae2822": _airfoil(
        ([-1, -1.5], [2.5, 2]), [0.96746538], [0.17268029]),
    "compressible_flow/bluff": _airfoil(
        ([-9.0, -9.0], [9.0, 9.0]), [0.95306754], [0.3144897]),

    # --- compressible flow ---
    "compressible_flow/CE-Gauss": _ce("rigno", 2.513),
    "compressible_flow/CE-RP": _ce("rigno", 0.215),
    "compressible_flow/CE-CRP": _ce("gaot", 0.553),
    "compressible_flow/CE-KH": _ce("gaot", 1.0),
    "compressible_flow/CE-RPUI": _ce("gaot", 1.33),

    # --- incompressible fluids ---
    "incompressible_fluids/NS-Gauss": _ns("rigno"),
    "incompressible_fluids/NS-PwC": _ns("rigno"),
    "incompressible_fluids/NS-SL": _ns("rigno"),
    "incompressible_fluids/NS-SVS": _ns("rigno"),
    "incompressible_fluids/NS-Sines": _ns("gaot"),

    # --- elliptic PDEs ---
    "elliptic_pdes/Elasticity": Metadata(
        periodic=False, group_u="u", group_c="c", group_x="x", type="rigno",
        domain_x=([0, 0], [1, 1]), domain_t=None, fix_x=False,
        active_variables=[0], chunked_variables=[0], num_variable_chunks=1,
        signed={"u": [False], "c": [False]},
        names={"u": ["$\\sigma$"], "c": ["$d$"]},
        global_mean=[187.477], global_std=[127.046],
    ),
    "elliptic_pdes/Poisson-C-Sines": Metadata(
        periodic=False, group_u="u", group_c="c", group_x="x", type="rigno",
        domain_x=([-0.5, -0.5], [1.5, 1.5]), domain_t=None, fix_x=True,
        active_variables=[0], chunked_variables=[0], num_variable_chunks=1,
        signed={"u": [True], "c": [True]},
        names={"u": ["$u$"], "c": ["$f$"]},
        global_mean=[0.0], global_std=[0.00064911455],
    ),
    "elliptic_pdes/Poisson-Gauss": Metadata(
        periodic=False, group_u="u", group_c="c", group_x="x", type="rigno",
        domain_x=([0, 0], [1, 1]), domain_t=None, fix_x=True,
        active_variables=_ACTIVE_PE, chunked_variables=_CHUNK_PE,
        num_variable_chunks=len(set(_CHUNK_PE)),
        signed=_SIGNED_PE, names=_NAMES_PE,
        global_mean=[0.0005603458434937093], global_std=[0.02401226126952699],
    ),

    # --- parabolic PDEs ---
    "parabolic_pdes/Heat-L-Sines": Metadata(
        periodic=False, group_u="u", group_c=None, group_x="x", type="rigno",
        domain_x=([0.0, 0.0], [1.0, 1.0]), domain_t=(0, 0.002), fix_x=True,
        active_variables=[0], chunked_variables=[0], num_variable_chunks=1,
        signed={"u": [True], "c": None},
        names={"u": ["$u$"], "c": None},
        global_mean=[-0.009399102], global_std=[0.020079814],
    ),
    "parabolic_pdes/ACE": Metadata(
        periodic=False, group_u="u", group_c=None, group_x="x", type="rigno",
        domain_x=([0, 0], [1, 1]), domain_t=(0, 0.0002), fix_x=True,
        active_variables=_ACTIVE_RD, chunked_variables=_CHUNK_RD,
        num_variable_chunks=len(set(_CHUNK_RD)),
        signed=_SIGNED_RD, names=_NAMES_RD,
        global_mean=[0.002484262], global_std=[0.65351176],
    ),

    # --- hyperbolic PDEs ---
    "hyperbolic_pdes/Wave-C-Sines": Metadata(
        periodic=False, group_u="u", group_c=None, group_x="x", type="rigno",
        domain_x=([-0.5, -0.5], [1.5, 1.5]), domain_t=(0, 0.1), fix_x=True,
        active_variables=[0], chunked_variables=[0], num_variable_chunks=1,
        signed={"u": [True], "c": None},
        names={"u": ["$u$"], "c": None},
        global_mean=[0.0], global_std=[0.011314605],
    ),
    "hyperbolic_pdes/Wave-Layer": Metadata(
        periodic=False, group_u="u", group_c="c", group_x="x", type="rigno",
        domain_x=([0, 0], [1, 1]), domain_t=(0, 1), fix_x=True,
        active_variables=_ACTIVE_WE, chunked_variables=_CHUNK_WE,
        num_variable_chunks=len(set(_CHUNK_WE)),
        signed=_SIGNED_WE, names=_NAMES_WE,
        global_mean=[0.03467443221585092], global_std=[0.10442421752963911],
    ),
    "hyperbolic_pdes/Wave-Gauss": Metadata(
        periodic=False, group_u="u", group_c="c", group_x="x", type="rigno",
        domain_x=([0, 0], [1, 1]), domain_t=(0, 1), fix_x=True,
        active_variables=_ACTIVE_WE, chunked_variables=_CHUNK_WE,
        num_variable_chunks=len(set(_CHUNK_WE)),
        signed=_SIGNED_WE, names=_NAMES_WE,
        global_mean=[0.0334376316], global_std=[0.1171879068],
    ),
    "hyperbolic_pdes/Wave-L-Sines": Metadata(
        periodic=False, group_u="u", group_c=None, group_x="x", type="gaot",
        domain_x=([0.5, 0.0], [1.5, 1.0]), domain_t=(0, 0.1), fix_x=True,
        active_variables=[0], chunked_variables=[0], num_variable_chunks=1,
        signed={"u": [True], "c": None},
        names={"u": ["$u$"], "c": None},
        global_mean=[0.0], global_std=[0.01080257],
    ),
}
