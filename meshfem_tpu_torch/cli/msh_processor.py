"""RPN field-processing calculator over MSH fields (counterpart of
``meshfem_tpu/cli/msh_processor.py``; parity with
``tools/msh_processor.cc`` + ``tools/ValueOperations/*.inl``):

    python -m meshfem_tpu_torch.cli.msh_processor in.msh \\
        -e 'u' norm max print \\
        -e 'stress' vonMises elementAverage outMSH:out.msh [--device cuda]

Ops (reference names; ':' attaches an argument):
  stack     dup pop swap reverse push:<v> pull:<name> rename:<name>
            extract:<name> extractAll list
  binary    add sub mul div
  unary     abs neg sqrt scale:<s> set:<v>
  reduce    min max minMag maxMag sum mean norm index percentile:<p>
            (inner reduction; prefix 'outer:' reduces over the field index:
             outer:max, outer:mean, ...)
  smatrix   vonMises eigenvalues frobeniusNorm
  mesh      generate:<volume|barycenter> expression:<e[,e,e]>
            elementAverage smoothedElementField transferFieldsToPerElem
            sample:<x,y[,z]>
  io        import_sfield:<name=path.txt> outMSH:<path> print noprint

The values on the stack are numpy arrays.  ``vonMises``, ``eigenvalues``
(``flat_to_sym`` and ``eigvalsh``), ``generate:volume``,
``smoothedElementField``'s volumes and ``sample:`` compute with the port's
torch functions on ``--device`` (the CUDA device by default); ``sample:``
takes the port's ``FieldSampler`` and ``expression:`` its
``utils.expressions``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import config


class Ctx:
    def __init__(self, V, F, fields, device=None):
        self.V, self.F, self.fields = V, F, fields
        self._device = device
        self._geom = None
        self.printed = False

    @property
    def device(self) -> torch.device:
        """``--device``, resolved at the first op that computes with
        torch."""
        return config.resolve_device(self._device)

    @property
    def geom(self):
        if self._geom is None:
            from ..mesh import FEMMesh

            dim = 2 if np.allclose(self.V[:, 2:], 0) and \
                self.F.shape[1] == 3 else 3
            self._geom = FEMMesh(self.V[:, :dim], self.F)
        return self._geom


class Named:
    def __init__(self, name, data):
        self.name = name
        self.data = np.asarray(data)


def _reduce(a, op, axis):
    if op == "min":
        return a.min(axis=axis)
    if op == "max":
        return a.max(axis=axis)
    if op == "sum":
        return a.sum(axis=axis)
    if op == "mean":
        return a.mean(axis=axis)
    if op == "norm":
        return np.sqrt((a ** 2).sum(axis=axis))
    if op == "minMag":
        return np.take_along_axis(
            a, np.expand_dims(np.abs(a).argmin(axis=axis), axis),
            axis).squeeze(axis)
    if op == "maxMag":
        return np.take_along_axis(
            a, np.expand_dims(np.abs(a).argmax(axis=axis), axis),
            axis).squeeze(axis)
    if op == "index" or op.startswith("index:"):
        # ReductionIndex (Reductions.inl:54-65): extract the value at the
        # requested index; out-of-bounds is an error (index 0 if no arg).
        _, _, iarg = op.partition(":")
        i = int(iarg) if iarg else 0
        n = a.shape[axis]
        if not (0 <= i < n):
            raise ValueError(f"Out-of-bounds 'index' reduction: {i} >= {n}")
        return np.take(a, i, axis=axis)
    raise ValueError(op)


_REDUCTIONS = ("min", "max", "minMag", "maxMag", "norm", "sum", "mean",
               "index")


def _on(ctx: Ctx, data) -> torch.Tensor:
    """A stack value as a tensor on the calculator's device."""
    return torch.as_tensor(np.asarray(data), device=ctx.device)


def apply_op(stack, tok, ctx: Ctx):
    from ..physics.elasticity import von_mises
    from ..fem.flattening import flat_to_sym

    op, _, arg = tok.partition(":")

    def pop():
        return stack.pop()

    binops = {"add": np.add, "sub": np.subtract, "mul": np.multiply,
              "div": np.divide}
    if op in ctx.fields:
        stack.append(Named(op, ctx.fields[op]["data"].squeeze()))
    elif op in binops:
        b, a = pop(), pop()
        stack.append(Named(f"{op}({a.name},{b.name})",
                           binops[op](a.data, b.data)))
    elif op == "neg":
        a = pop()
        stack.append(Named(f"neg({a.name})", -a.data))
    elif op == "abs":
        a = pop()
        stack.append(Named(f"abs({a.name})", np.abs(a.data)))
    elif op == "sqrt":
        a = pop()
        stack.append(Named(f"sqrt({a.name})", np.sqrt(a.data)))
    elif op == "scale":
        a = pop()
        stack.append(Named(f"scale({a.name})", float(arg) * a.data))
    elif op == "set":
        a = pop()
        stack.append(Named(f"set({a.name})",
                           np.full_like(a.data, float(arg))))
    elif op in _REDUCTIONS:
        a = pop()
        axis = -1 if a.data.ndim > 1 else 0
        full = op if not arg else f"{op}:{arg}"
        stack.append(Named(f"{full}({a.name})", _reduce(a.data, full, axis)))
    elif op == "outer":
        a = pop()
        stack.append(Named(f"outer{arg}({a.name})", _reduce(a.data, arg, 0)))
    elif op == "percentile":
        a = pop()
        stack.append(Named(f"p{arg}({a.name})",
                           np.percentile(a.data, float(arg))))
    elif op == "vonMises" or op == "vonmises":
        a = pop()
        dim = 2 if a.data.shape[-1] == 3 else 3
        vm = von_mises(_on(ctx, a.data), dim)
        stack.append(Named(f"vonMises({a.name})", vm.cpu().numpy()))
    elif op == "eigenvalues":
        a = pop()
        dim = {1: 1, 3: 2, 6: 3}[a.data.shape[-1]]
        full = flat_to_sym(_on(ctx, a.data), dim)
        stack.append(Named(f"eigenvalues({a.name})",
                           torch.linalg.eigvalsh(full).cpu().numpy()))
    elif op == "frobeniusNorm":
        a = pop()
        from ..fem.flattening import shear_doubler

        dim = 2 if a.data.shape[-1] == 3 else 3
        S = shear_doubler(dim)
        stack.append(Named(f"frob({a.name})",
                           np.sqrt((a.data ** 2 * S).sum(axis=-1))))
    elif op == "elementAverage":
        a = pop()
        mesh = ctx.geom
        if len(a.data) != mesh.num_nodes:
            raise ValueError("elementAverage needs a nodal field")
        stack.append(Named(f"elementAverage({a.name})",
                           a.data[np.asarray(mesh.F)].mean(axis=1)))
    elif op == "smoothedElementField":
        a = pop()
        mesh = ctx.geom
        if len(a.data) != mesh.num_elements:
            raise ValueError("smoothedElementField needs an element field")
        vol = mesh.geometry(ctx.device).volume.cpu().numpy()
        w = np.zeros(mesh.num_nodes)
        acc = np.zeros((mesh.num_nodes,) + a.data.shape[1:])
        for c in range(mesh.F.shape[1]):
            np.add.at(w, mesh.F[:, c], vol)
            np.add.at(acc, mesh.F[:, c],
                      a.data * (vol.reshape((-1,) + (1,) *
                                            (a.data.ndim - 1))))
        stack.append(Named(
            f"smoothed({a.name})",
            acc / w.reshape((-1,) + (1,) * (a.data.ndim - 1))))
    elif op == "transferFieldsToPerElem":
        # transfer every nodal field on the stack to element barycenters
        for i, v in enumerate(stack):
            if np.ndim(v.data) >= 1 and len(v.data) == ctx.geom.num_nodes:
                stack[i] = Named(v.name,
                                 v.data[np.asarray(ctx.geom.F)].mean(axis=1))
    elif op == "sample":
        from ..analysis.field_sampler import FieldSampler

        a = pop()
        pt = np.asarray([float(x) for x in arg.split(",")])
        mesh = ctx.geom
        fs = FieldSampler(mesh)
        pts = pt[None, :mesh.V.shape[1]]
        if len(a.data) == mesh.num_nodes:
            val = fs.sample_nodal(_on(ctx, a.data), pts)
        else:
            val = fs.sample_element(_on(ctx, a.data), pts)
        stack.append(Named(f"sample({a.name})", val[0].cpu().numpy()))
    elif op == "generate":
        mesh = ctx.geom
        if arg == "volume":
            stack.append(Named(
                "volume", mesh.geometry(ctx.device).volume.cpu().numpy()))
        elif arg == "barycenter":
            stack.append(Named("barycenter",
                               np.asarray(mesh.V)[mesh.F].mean(axis=1)))
        else:
            raise ValueError(f"unknown mesh property {arg!r}")
    elif op == "expression":
        from ..utils.expressions import evaluate

        comps = arg.split(",")
        pts = ctx.V
        cols = [np.asarray(evaluate(c, pts)) for c in comps]
        data = cols[0] if len(cols) == 1 else np.stack(cols, axis=-1)
        stack.append(Named(f"expr({arg})", data))
    elif op == "import_sfield":
        name, _, path = arg.partition("=")
        stack.append(Named(name, np.loadtxt(path)))
    elif op == "extract":
        for v in list(stack):
            if v.name == arg:
                stack.clear()
                stack.append(v)
                return
        raise ValueError(f"no value named {arg!r}")
    elif op == "extractAll":
        for name, f in ctx.fields.items():
            stack.append(Named(name, f["data"].squeeze()))
    elif op == "list":
        for name in ctx.fields:
            print(name)
        ctx.printed = True
    elif op == "pull":
        for i, v in enumerate(stack):
            if v.name == arg:
                stack.append(stack.pop(i))
                return
        raise ValueError(f"couldn't find {arg!r} for pull")
    elif op == "rename":
        stack[-1] = Named(arg, stack[-1].data)
    elif op == "dup":
        stack.append(Named(stack[-1].name, stack[-1].data.copy()
                           if np.ndim(stack[-1].data) else stack[-1].data))
    elif op == "pop":
        pop()
    elif op == "swap":
        stack[-1], stack[-2] = stack[-2], stack[-1]
    elif op == "reverse":
        stack.reverse()
    elif op == "print":
        top = stack[-1]
        if np.ndim(top.data) == 0:
            print(f"{top.name}: {float(top.data)}")
        else:
            print(f"{top.name}: field shape {np.shape(top.data)}, range "
                  f"[{np.min(top.data):.6g}, {np.max(top.data):.6g}]")
        ctx.printed = True
    elif op == "noprint":
        ctx.printed = True
    elif op == "outMSH":
        from ..io import meshio

        out_fields = []
        for v in stack:
            if np.ndim(v.data) == 0:
                continue
            where = "node" if len(v.data) == len(ctx.V) else "element"
            out_fields.append({
                "name": v.name, "data": v.data, "where": where,
                "kind": "scalar" if v.data.ndim == 1 else "vector"})
        meshio.save_msh(arg, ctx.V, ctx.F, fields=out_fields)
        print(f"wrote {arg}")
        ctx.printed = True
    else:
        try:
            stack.append(Named(op, np.float64(op)))
        except ValueError as exc:
            raise ValueError(f"unknown op/field {op!r}") from exc


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mesh")
    ap.add_argument("-e", "--expr", nargs="+", action="append",
                    default=[], help="RPN expression (repeatable)")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--name", default="processed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ..io import meshio, msh_fields

    V, F = meshio.load(args.mesh)
    fields = msh_fields.read_fields(args.mesh)
    ctx = Ctx(np.asarray(V), np.asarray(F), fields, args.device)

    results = []
    for expr in args.expr:
        stack = []
        ctx.printed = False
        for tok in expr:
            apply_op(stack, tok, ctx)
        if stack:
            # implicit print of the final value (reference behavior)
            if not ctx.printed:
                apply_op(stack, "print", ctx)
            results.append(stack[-1])

    if args.output and results:
        out_fields = []
        for i, r in enumerate(results):
            if np.ndim(r.data) == 0:
                continue
            where = "node" if len(r.data) == len(V) else "element"
            out_fields.append({"name": f"{args.name}_{i}", "data": r.data,
                               "where": where,
                               "kind": "scalar" if r.data.ndim == 1
                               else "vector"})
        meshio.save_msh(args.output, V, F, fields=out_fields)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
