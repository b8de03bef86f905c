"""HALF search space (paper §VI).

A copy of ``repro/core/search_space.py``, imports repointed to the port.

"The search space constitutes of depthwise separable convolutions with 60
different hyperparameter configurations and max pooling with 4 different
strides.  All DNNs end with a global average-pooling layer followed by a
fully-connected layer.  The depth of the topology is chosen by the NAS but
restricted between 2 and 15 layers (final layers not included)."

Hardware-awareness dimension 1 (§III-A): the space is constrained to layers
in the hardware library, including valid hyperparameter combinations and the
quantization of inputs, weights and feature maps.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Sequence, Tuple

from repro_torch.hwlib.layers import DENSE, DWSEP_CONV, GLOBALPOOL, MAXPOOL, LayerSpec
from repro_torch.hwlib.quant import QuantConfig

# 60 depthwise-separable conv configurations: 5 channel counts x 4 kernel
# sizes x 3 strides (Fig. 4's topologies use channels in {2..32}, kernels
# down to size 1 and striding layers).
CONV_CHANNELS: Tuple[int, ...] = (2, 4, 8, 16, 32)
CONV_KERNELS: Tuple[int, ...] = (1, 3, 5, 7)
CONV_STRIDES: Tuple[int, ...] = (1, 2, 4)

# 4 max-pooling strides (window == stride).
POOL_STRIDES: Tuple[int, ...] = (2, 4, 8, 16)

MIN_DEPTH = 2
MAX_DEPTH = 15

# Quantization choices searched by the NAS (inputs / weights / feature maps).
WEIGHT_BITS: Tuple[int, ...] = (4, 8)
ACT_BITS: Tuple[int, ...] = (8, 16)
INPUT_BITS: Tuple[int, ...] = (8, 16)

# Input decimation of the 60000-sample records (Fig. 4: inputs (1875,2) and
# (3750,2) — i.e. decimation 32 and 16 are both reachable by the search).
INPUT_DECIMATIONS: Tuple[int, ...] = (16, 32)

N_CLASSES = 2
RAW_LENGTH = 60000
N_CHANNELS = 2


def build_op_table() -> List[LayerSpec]:
    """The op catalogue indexed by the genome's function genes."""
    ops: List[LayerSpec] = []
    for c, k, s in itertools.product(CONV_CHANNELS, CONV_KERNELS, CONV_STRIDES):
        ops.append(LayerSpec(kind=DWSEP_CONV, out_channels=c, kernel_size=k,
                             stride=s))
    for s in POOL_STRIDES:
        ops.append(LayerSpec(kind=MAXPOOL, stride=s))
    return ops


OP_TABLE: List[LayerSpec] = build_op_table()
N_OPS = len(OP_TABLE)  # 64 = 60 convs + 4 pools
assert N_OPS == 64


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Bundles the op table with genome-level choices."""

    ops: Tuple[LayerSpec, ...] = tuple(OP_TABLE)
    max_depth: int = MAX_DEPTH
    min_depth: int = MIN_DEPTH
    weight_bits: Tuple[int, ...] = WEIGHT_BITS
    act_bits: Tuple[int, ...] = ACT_BITS
    input_bits: Tuple[int, ...] = INPUT_BITS
    input_decimations: Tuple[int, ...] = INPUT_DECIMATIONS
    n_classes: int = N_CLASSES

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    def quant_config(self, w_idx: int, a_idx: int, i_idx: int) -> QuantConfig:
        return QuantConfig(weight_bits=self.weight_bits[w_idx],
                           act_bits=self.act_bits[a_idx],
                           input_bits=self.input_bits[i_idx])

    def input_length(self, dec_idx: int) -> int:
        return RAW_LENGTH // self.input_decimations[dec_idx]

    def head_specs(self) -> Tuple[LayerSpec, LayerSpec]:
        """The fixed GAP + dense head appended to every phenotype.

        Single source of truth for the head's content and order: the
        sentinel op ids ``n_ops + i`` used by the batched engine
        (PopulationEncoding.phenotype_ops, hw_model.table_for_space) index
        into this tuple.
        """
        return (LayerSpec(kind=GLOBALPOOL),
                LayerSpec(kind=DENSE, out_channels=self.n_classes))


DEFAULT_SPACE = SearchSpace()
