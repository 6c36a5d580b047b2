"""Traffic: the inputs of a cell and their arrival times, made from
`--seed` by one general generator (`generate.py`) out of a mix's
parameters (`mixes/<traffic>.json`) and the configuration's sizes.

Frozen copies of the repo's generators (the demo rig, the procedural pose
bank, the synthetic scene placement, Gaussian heatmap rendering), so that
a change to the program cannot change what the benchmark feeds it.
"""
