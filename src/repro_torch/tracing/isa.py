"""Copy of ``repro/tracing/isa.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

SASS-like ISA for the synthetic trace substrate.

The trace format follows the paper's Table 1 per-instruction record:
CTA coords, warp id, PC, active mask, dest regs, opcode, src regs, memory
width, dynamic values.  Opcodes are grouped into classes consumed by the
timing model (instruction mix) and used as token IDs by the HRG features.
"""

from __future__ import annotations

# opcode -> (class, typical latency cycles, flops per lane)
OPCODES: dict[str, tuple[str, int, int]] = {
    # memory
    "LDG": ("mem_load", 400, 0),     # global load
    "STG": ("mem_store", 40, 0),     # global store
    "LDS": ("smem", 30, 0),          # shared load
    "STS": ("smem", 30, 0),          # shared store
    "LDC": ("mem_load", 100, 0),     # constant load
    "RED": ("mem_store", 400, 0),    # global reduction (atomic)
    # fp32
    "FADD": ("fp", 4, 1),
    "FMUL": ("fp", 4, 1),
    "FFMA": ("fp", 4, 2),
    "FSETP": ("fp", 4, 0),
    "MUFU": ("sfu", 16, 1),          # special function (exp/rsqrt/sin)
    # fp16 / tensor
    "HMMA": ("tensor", 16, 128),     # tensor-core MMA (per-lane amortized)
    "HFMA2": ("fp", 4, 4),
    # int / logic
    "IADD3": ("alu", 4, 0),
    "IMAD": ("alu", 5, 0),
    "ISETP": ("alu", 4, 0),
    "LOP3": ("alu", 4, 0),
    "SHF": ("alu", 4, 0),
    "MOV": ("alu", 2, 0),
    "S2R": ("alu", 8, 0),
    "I2F": ("alu", 8, 0),
    # control / sync
    "BRA": ("control", 8, 0),
    "EXIT": ("control", 4, 0),
    "BAR": ("barrier", 30, 0),
    "SHFL": ("shuffle", 10, 0),      # warp shuffle
}

OPCODE_LIST = sorted(OPCODES)
OPCODE_IDS = {op: i for i, op in enumerate(OPCODE_LIST)}
NUM_OPCODES = len(OPCODE_LIST)

INSTR_CLASSES = sorted({cls for cls, _, _ in OPCODES.values()})
CLASS_IDS = {c: i for i, c in enumerate(INSTR_CLASSES)}

OPCODE_CLASS = {OPCODE_IDS[op]: CLASS_IDS[cls] for op, (cls, _, _) in OPCODES.items()}
OPCODE_LATENCY = {OPCODE_IDS[op]: lat for op, (_, lat, _) in OPCODES.items()}
OPCODE_FLOPS = {OPCODE_IDS[op]: fl for op, (_, _, fl) in OPCODES.items()}

# pseudo-node kinds (paper §3.2: operations inside an instruction needing
# explicit modeling, e.g. memory reference computation)
PSEUDO_KINDS = ["MemRef", "PredGuard", "AddrCalc"]
PSEUDO_IDS = {k: i for i, k in enumerate(PSEUDO_KINDS)}

# variable-node kinds
VAR_KINDS = ["reg", "mem", "init"]
VAR_IDS = {k: i for i, k in enumerate(VAR_KINDS)}
