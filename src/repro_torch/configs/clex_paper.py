"""The paper's own simulation settings (Sec. III); the port's copy of the
JAX package's ``configs/clex_paper.py``."""

from ..core.topology import CLEXTopology

# C(1/4, 4): 32^4 ~ 1.05M nodes; C(1/3, 3): 64^3 ~ 262k nodes
PAPER_TOPOLOGIES = {
    "c14_4": CLEXTopology(m=32, L=4),
    "c13_3": CLEXTopology(m=64, L=3),
}

# messages per node: ~0.9 * degree (dense) and matching torus throughput (light)
PAPER_TRAFFIC = {
    ("c14_4", "dense"): 28,
    ("c13_3", "dense"): 57,
    ("c14_4", "light"): 4,
    ("c13_3", "light"): 5,
}

PAPER_TABLES = {
    # table -> level -> (max_rds, avg_rds, max_avg_load, avg_hops)
    "table1": {1: (11, 13.69, 33.44, 10.63), 2: (2, 4.11, 30.33, 4), 3: (2, 2.05, 28.06, 2),
               4: (2, 1.03, 28, 1)},
    "table2": {1: (9, 6.90, 62.06, 5.34), 2: (2, 2.03, 57.30, 2), 3: (2, 1.01, 57, 1)},
    "table3": {1: (5, 9.02, 9.02, 10.53), 2: (1, 4, 7.32, 4), 3: (1, 2, 4.02, 2), 4: (1, 1, 4, 1)},
    "table4": {1: (5, 4.32, 10.36, 5.11), 2: (1, 2, 5.09, 2), 3: (1, 1, 5, 1)},
}

PAPER_DERIVED = {
    # (propagation_ratio, hop_delay_reduction, bandwidth_gain)
    ("c14_4", "dense"): (2.5, 7.3, 8.6),
    ("c13_3", "dense"): (2.0, 9.7, 11.5),
    ("c14_4", "light"): (2.3, 9.5, None),
    ("c13_3", "light"): (1.8, 13.1, None),
}
