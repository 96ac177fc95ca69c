"""One rank of a multi-device cell (portbench.loops.render_sharded):

    python -m portbench.rank '<json arguments>'

with RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set."""

import json
import sys

from portbench.loops.render_sharded import rank_main

if __name__ == "__main__":
    rank_main(json.loads(sys.argv[1]))
