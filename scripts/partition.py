"""Generate a .ptn partition file for a mesh (print_partition analog).

Run:  python scripts/partition.py mesh.msh 8 out.ptn
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pumipic_jax.mesh import gmsh
from pumipic_jax.parallel import picparts as ppm


def main():
    mesh_path, nranks, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    coords, ev, cls = gmsh.read_msh(mesh_path)
    owners = ppm.partition_rcb(coords, ev, nranks)
    ppm.write_ptn(out, owners)
    print(f"wrote {out}: {len(owners)} elements over {nranks} ranks")


if __name__ == "__main__":
    main()
