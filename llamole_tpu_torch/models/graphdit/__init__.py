from .api import GraphDiT
from .config import DataInfo, GraphDiTConfig, build_data_info_from_smiles
