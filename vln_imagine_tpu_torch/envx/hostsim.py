"""Host-side reference simulator with the MatterSim graph-mode surface.

Pure-python stand-in for the external MatterSim C++ simulator as the reference
uses it: rendering disabled, discretized 30-degree viewing angles, graph
traversal + pose bookkeeping only (VLN-HAMT/finetune_src/r2r/env.py:50-93).
The port's own copy of the JAX package's simulator.  It serves the port's
tests as an oracle for `observe_*` and `step_*`; nothing on the device path
uses it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from vln_imagine_tpu_torch.envx.compiler import ScanGraph, closest_view, heading_elevation

RAD30 = math.radians(30.0)


@dataclass
class Location:
    viewpointId: str
    ix: int
    rel_heading: float = 0.0
    rel_elevation: float = 0.0


@dataclass
class SimState:
    scanId: str
    location: Location
    heading: float
    elevation: float
    viewIndex: int
    navigableLocations: list[Location] = field(default_factory=list)


class GraphSimulator:
    """newEpisode / makeAction / getState over a ScanGraph."""

    def __init__(self, graphs: dict[str, ScanGraph], views: int = 36):
        self.graphs = graphs
        self.views = views
        self.per_row = views // 3
        self.state: SimState | None = None
        self._neigh: dict[str, list[list[int]]] = {}
        for sid, g in graphs.items():
            neigh = [[] for _ in range(g.num_nodes)]
            for a, b in g.edges:
                neigh[a].append(b)
                neigh[b].append(a)
            self._neigh[sid] = [sorted(x) for x in neigh]

    def _view_index(self, heading: float, elevation: float) -> int:
        col = int(round(heading / (2 * math.pi / self.per_row))) % self.per_row
        row = int(round(elevation / RAD30)) + 1
        row = min(max(row, 0), 2)
        return row * self.per_row + col

    def _snap(self, heading: float, elevation: float):
        vi = self._view_index(heading, elevation)
        h = (vi % self.per_row) * (2 * math.pi / self.per_row)
        e = (vi // self.per_row - 1) * RAD30
        return h, e, vi

    def _navigable(self, scan: str, node: int) -> list[Location]:
        """Current node first, then neighbours sorted by slot order."""
        g = self.graphs[scan]
        locs = [Location(g.node_ids[node], node)]
        st = self.state
        for j in self._neigh[scan][node]:
            h, e = heading_elevation(g.xyz[node], g.xyz[j])
            locs.append(Location(
                g.node_ids[j], j,
                rel_heading=_wrap(h - (st.heading if st else 0.0)),
                rel_elevation=e - (st.elevation if st else 0.0)))
        return locs

    def newEpisode(self, scan: str, viewpoint: str, heading: float,
                   elevation: float = 0.0):
        g = self.graphs[scan]
        node = g.id_to_index[viewpoint]
        h, e, vi = self._snap(heading, elevation)
        self.state = SimState(scan, Location(viewpoint, node), h, e, vi)
        self.state.navigableLocations = self._navigable(scan, node)

    def makeAction(self, index: int, heading_delta: float, elevation_delta: float):
        """index > 0 moves to navigableLocations[index]; heading/elevation
        deltas are in 30-degree increments (discretized mode)."""
        st = self.state
        assert st is not None
        scan = st.scanId
        node = st.location.ix
        if index > 0:
            node = st.navigableLocations[index].ix
            st.location = Location(self.graphs[scan].node_ids[node], node)
        h = st.heading + heading_delta * (2 * math.pi / self.per_row)
        e = st.elevation + elevation_delta * RAD30
        h = h % (2 * math.pi)
        e = min(max(e, -RAD30), RAD30)
        st.heading, st.elevation, st.viewIndex = self._snap(h, e)
        st.navigableLocations = self._navigable(scan, node)

    def getState(self) -> SimState:
        return self.state

    # convenience used by parity tests -------------------------------------
    def candidates(self):
        """make_candidate-equivalent: {neighbourId: (pointId, heading, elev)}
        via the closest-view rule (env.py:221-291)."""
        st = self.state
        g = self.graphs[st.scanId]
        out = {}
        for j in self._neigh[st.scanId][st.location.ix]:
            h, e = heading_elevation(g.xyz[st.location.ix], g.xyz[j])
            out[g.node_ids[j]] = (closest_view(h, e, self.views), h, e)
        return out


def _wrap(a: float) -> float:
    while a > math.pi:
        a -= 2 * math.pi
    while a < -math.pi:
        a += 2 * math.pi
    return a
