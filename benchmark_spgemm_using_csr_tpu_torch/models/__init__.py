"""Applications on the SpGEMM substrate: AMG (``amg``) and ILU0 with
preconditioned CG (``ilu0``)."""
