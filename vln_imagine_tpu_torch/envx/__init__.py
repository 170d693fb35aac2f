from vln_imagine_tpu_torch.envx.tables import WorldTables, EpisodeBatch, EnvState
from vln_imagine_tpu_torch.envx.compiler import compile_world, ScanGraph
from vln_imagine_tpu_torch.envx.synthetic import synthetic_world, synthetic_episodes
