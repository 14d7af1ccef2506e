from .model import GraphCLIP, GraphCLIPConfig
