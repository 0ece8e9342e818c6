"""Paged-attention decode (block-table K/V page indirection): the CUDA
kernels' wrappers, their plain version and the int8 page quantizer."""
