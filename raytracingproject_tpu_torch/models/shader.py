"""Shader graphs (JAX counterpart: raytracingproject_tpu/models/shader.py).

A graph is a DAG of nodes with named links. `ShaderGraph.evaluate` walks
it in topological order and calls each node's torch eval from the
registry in models/shader_nodes.py, keyed by node class name — so a
graph converted from the JAX package (models/scene.py kg_from_jax)
evaluates through the same registry. A node class outside the registry
raises NotImplementedError. The output node's surface socket gives the
surface closures and its volume socket the volume closures; a linked
displacement socket raises.
"""

from __future__ import annotations

import numpy as np

from raytracingproject_tpu_torch.models.node import Node, SocketType as S
from raytracingproject_tpu_torch.ops import closures as cl


class ShaderNode(Node):
    """Base shader-graph node: INPUTS = [(name, type, default), ...],
    OUTPUTS = [(name, type), ...]; PARAMS are static sockets (enums)."""

    INPUTS = []
    OUTPUTS = []
    PARAMS = []

    def __init_subclass__(cls, **kw):
        sockets = list(cls.PARAMS)
        for (iname, itype, default) in cls.INPUTS:
            if itype == "closure":
                continue
            st = {"float": S.FLOAT, "color": S.COLOR,
                  "vector": S.VECTOR, "normal": S.NORMAL}[itype]
            sockets.append(S(iname, st, default))
        cls.SOCKETS = sockets
        super().__init_subclass__(**kw)

    def input_default(self, iname, itype):
        if itype == "closure":
            return None
        v = getattr(self, iname)
        if itype in ("color", "vector", "normal"):
            return np.asarray(v, np.float32)
        return v


class OutputNode(ShaderNode):
    INPUTS = [("surface", "closure", None), ("volume", "closure", None),
              ("displacement", "normal", (0.0, 0.0, 0.0))]


class ShaderGraph:
    """DAG of shader nodes with named links."""

    def __init__(self):
        self.nodes = []
        self.links = {}  # (id(to_node), to_socket) -> (from_node, socket)
        self.output_node = OutputNode("output")
        self.add(self.output_node)

    def add(self, node):
        if node not in self.nodes:
            self.nodes.append(node)
        return node

    def connect(self, from_node, from_socket, to_node, to_socket):
        outs = [o[0] for o in from_node.OUTPUTS]
        ins = [i[0] for i in to_node.INPUTS]
        if from_socket not in outs:
            raise ValueError(f"{from_node} has no output '{from_socket}'")
        if to_socket not in ins:
            raise ValueError(f"{to_node} has no input '{to_socket}'")
        self.links[(id(to_node), to_socket)] = (from_node, from_socket)

    def topo_order(self):
        order, seen, onstack = [], set(), set()

        def visit(n):
            if id(n) in seen:
                return
            if id(n) in onstack:
                raise ValueError("shader graph contains a cycle")
            onstack.add(id(n))
            for (iname, _t, _d) in n.INPUTS:
                link = self.links.get((id(n), iname))
                if link is not None:
                    visit(link[0])
            onstack.discard(id(n))
            seen.add(id(n))
            order.append(n)

        visit(self.output_node)
        return order

    def evaluate(self, ctx):
        """Evaluate the graph over the wavefront described by `ctx`
        (ops/shade.py ShaderData). Returns {'surface': closures,
        'volume': volume closures or None}."""
        from raytracingproject_tpu_torch.models.shader_nodes import eval_node
        if self.links.get((id(self.output_node), "displacement")) \
                is not None:
            raise NotImplementedError("displacement is not ported")
        values = {}
        surface = volume = None
        for node in self.topo_order():
            inp = {}
            for (iname, itype, _d) in node.INPUTS:
                link = self.links.get((id(node), iname))
                if link is not None:
                    inp[iname] = values[(id(link[0]), link[1])]
                else:
                    inp[iname] = node.input_default(iname, itype)
            if node is self.output_node:
                surface, volume = inp.get("surface"), inp.get("volume")
                continue
            out = eval_node(node, ctx, inp)
            for (oname, _t) in node.OUTPUTS:
                values[(id(node), oname)] = out[oname]
        if surface is None:
            surface = cl.empty_closures(ctx.batch_shape, ctx.device)
        return {"surface": surface, "volume": volume}


class Shader(Node):
    """A material: graph + settings."""

    SOCKETS = [
        S("use_mis", S.BOOLEAN, True),
        S("use_transparent_shadow", S.BOOLEAN, True),
        S("volume_sampling_method", S.ENUM, "multiple_importance",
          {"distance": 0, "equiangular": 1, "multiple_importance": 2}),
    ]

    def __init__(self, name="shader", graph=None, **kwargs):
        super().__init__(name, **kwargs)
        self.graph = graph or ShaderGraph()
        self.slot = -1

    def evaluate_surface(self, ctx):
        return self.graph.evaluate(ctx)["surface"]

    def evaluate_volume(self, ctx):
        return self.graph.evaluate(ctx)["volume"]

    def analyze(self):
        """Static feature detection for the port's node classes (the JAX
        package's Shader.analyze :295 for these classes)."""
        from raytracingproject_tpu_torch.models import shader_nodes as sn
        g = self.graph
        self.has_surface_emission = False
        self.has_glossy = False
        self.has_subsurface = False
        self.has_volume = False
        self.has_heterogeneous_volume = False
        for node in g.nodes:
            if isinstance(node, (sn.EmissionNode, sn.BackgroundNode)):
                self.has_surface_emission = True
            if isinstance(node, sn.GlossyBsdfNode):
                self.has_glossy = True
            if isinstance(node, sn.SubsurfaceScatteringNode):
                self.has_subsurface = True
            if isinstance(node, sn.PrincipledVolumeNode):
                self.has_volume = True
                if g.links.get((id(node), "density")) is not None \
                        or g.links.get((id(node), "color")) is not None:
                    self.has_heterogeneous_volume = True
        if g.links.get((id(g.output_node), "volume")) is not None:
            self.has_volume = True
        # a volume with no surface closure: its surface is a transparent
        # boundary that shadow rays ignore
        self.volume_only = self.has_volume \
            and g.links.get((id(g.output_node), "surface")) is None
        return self
