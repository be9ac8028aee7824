"""The kernel lab: timing tools for the traversal kernels on the card.

``kernel_lab`` times each traversal route of ``dense_traverse.group_query``
on the benchmark box's cone group and the mesh benchmark's terrain group;
``cone_probe`` times the dense kernel's cone sweep with parts of its work
taken out (csrc/cone_probe.cu).  Counterparts of the repository's
``scripts_kernel_lab.py`` and ``scripts_cone_probe.py``.  ``grid_crossover``
times the grid kernel's leaf crossover (-D variants of its source);
``redesign_ab`` times the grid, supercell-tree and coefficient-table
kernels against an earlier checkout's.
"""
