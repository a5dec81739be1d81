"""The plain reference: exact k-mer counts of the generated reads, worked
out again in plain PyTorch from the reads alone, and the control that
breaks their exactness. Imports torch only: never the port, the JAX
package or JAX."""
