from extrack_tpu_torch.io.readers import read_table, read_trackmate_xml  # noqa: F401,E501
from extrack_tpu_torch.io import exporters  # noqa: F401
