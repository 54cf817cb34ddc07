from repro_torch.tracing.isa import OPCODES, OPCODE_IDS, INSTR_CLASSES
from repro_torch.tracing.tracer import KernelInvocation, WarpTrace, trace_kernel
from repro_torch.tracing.programs import PROGRAMS, get_program
