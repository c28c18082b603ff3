from mpmvs_torch.io.dmb import read_dmb, write_dmb
from mpmvs_torch.io.cams import read_cam_txt, write_cam_txt, read_pair_txt, write_pair_txt
from mpmvs_torch.io.ply import write_ply_binary, read_ply_binary

__all__ = [
    "read_dmb", "write_dmb",
    "read_cam_txt", "write_cam_txt", "read_pair_txt", "write_pair_txt",
    "write_ply_binary", "read_ply_binary",
]
