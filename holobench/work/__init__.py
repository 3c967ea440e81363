"""The least work of one iteration of each driver kind, counted from the
cell's shapes: ``per_iteration(config, traffic) -> {"flops", "bytes"}``,
float32 operations and bytes, each input read once and each output written
once, whatever implements the iteration."""

#: The float32 operations counted for one sine and cosine pair (or one
#: arctangent) of an argument.
SINCOS_FLOPS = 24
