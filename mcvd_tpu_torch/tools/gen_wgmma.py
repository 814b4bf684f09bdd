"""Write `mcvd_tpu_torch/csrc/wgmma_ops.cuh`: the `wgmma.mma_async` wrappers
that the attention kernels of `csrc/attention_wgmma.cuh` issue.

    python -m mcvd_tpu_torch.tools.gen_wgmma

A wgmma instruction names every accumulator register of the thread (N / 2
of them for m64nN), so each shape is its own inline-asm statement; this
script spells them out. Shapes:

  * `ss_bf16<N, kTA, kTB>`: m64nNk16, bf16 A and B from shared memory
    (descriptors), with the transpose flags (1: MN-major);
  * `rs_bf16<N, kTB>`: m64nNk16, bf16 A from registers (4 x 2 bf16);
  * `rs_tf32<N>`: m64nNk8, tf32 A from registers (4 words); tf32 takes B
    K-major only and has no transpose flags.

Each takes `acc` (0: D = A B, else D += A B) and accumulates in fp32.
"""

from __future__ import annotations

from pathlib import Path

OUT = Path(__file__).resolve().parent.parent / "csrc" / "wgmma_ops.cuh"
SS_BF16 = (32, 64)
RS_BF16 = (64, 128, 192)
RS_TF32 = (16, 24, 32, 64, 96, 128, 192)


def _regs(n):
    return ", ".join(f"%{i}" for i in range(n))


def _outs(n):
    return ", ".join(f'"+f"(d[{i}])' for i in range(n))


def _body(n_out, shape, types, a, b, p, tail, ins):
    return (f'  asm volatile(\n'
            f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{p}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.{shape}.f32.{types} "\n'
            f'      "{{{_regs(n_out)}}}, "\n'
            f'      "{a}, {b}, p, 1, 1{tail};\\n}}\\n"\n'
            f'      : {_outs(n_out)}\n'
            f'      : {ins});\n')


def ss_bf16(n):
    r = n // 2
    return (f"template <int kTA, int kTB>\n"
            f"__device__ __forceinline__ void ss_bf16_n{n}(float (&d)[{r}], uint64_t a, "
            f"uint64_t b, int acc) {{\n"
            + _body(r, f"m64n{n}k16", "bf16.bf16", f"%{r}", f"%{r + 1}", r + 2,
                    f", %{r + 3}, %{r + 4}",
                    '"l"(a), "l"(b), "r"(acc), "n"(kTA), "n"(kTB)')
            + "}\n")


def rs_bf16(n):
    r = n // 2
    a = "{" + ", ".join(f"%{r + i}" for i in range(4)) + "}"
    return (f"template <int kTB>\n"
            f"__device__ __forceinline__ void rs_bf16_n{n}(float (&d)[{r}], "
            f"const uint32_t (&a)[4], uint64_t b, int acc) {{\n"
            + _body(r, f"m64n{n}k16", "bf16.bf16", a, f"%{r + 4}", r + 5, f", %{r + 6}",
                    '"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(kTB)')
            + "}\n")


def rs_tf32(n):
    r = n // 2
    a = "{" + ", ".join(f"%{r + i}" for i in range(4)) + "}"
    return (f"__device__ __forceinline__ void rs_tf32_n{n}(float (&d)[{r}], "
            f"const uint32_t (&a)[4], uint64_t b, int acc) {{\n"
            + _body(r, f"m64n{n}k8", "tf32.tf32", a, f"%{r + 4}", r + 5, "",
                    '"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc)')
            + "}\n")


def dispatch(name, ns, tparams, targs, args, params):
    lines = [f"template <int N{tparams}>",
             f"__device__ __forceinline__ void {name}(float (&d)[N / 2], {params}) {{"]
    for i, n in enumerate(ns):
        kw = "if" if i == 0 else "} else if"
        lines.append(f"  {kw} constexpr (N == {n}) {{")
        lines.append(f"    {name}_n{n}{targs}(d, {args});")
    lines.append("  } else {")
    lines.append(f'    static_assert(N == 0, "{name}: no wgmma wrapper of this width");')
    lines.append("  }")
    lines.append("}")
    return "\n".join(lines) + "\n"


def render() -> str:
    parts = ["// Generated by `python -m mcvd_tpu_torch.tools.gen_wgmma`; do not edit.\n"
             "// wgmma.mma_async wrappers (sm_90a): m64nNk16 bf16 with A and B from\n"
             "// shared memory (ss) or A from registers (rs), and m64nNk8 tf32 with A\n"
             "// from registers. acc == 0: D = A B, else D += A B (fp32).\n\n"
             "#pragma once\n\n#include <stdint.h>\n\nnamespace wgmma {\n"]
    parts += [ss_bf16(n) for n in SS_BF16]
    parts += [rs_bf16(n) for n in RS_BF16]
    parts += [rs_tf32(n) for n in RS_TF32]
    parts.append(dispatch("ss_bf16", SS_BF16, ", int kTA, int kTB", "<kTA, kTB>",
                          "a, b, acc", "uint64_t a, uint64_t b, int acc"))
    parts.append(dispatch("rs_bf16", RS_BF16, ", int kTB", "<kTB>", "a, b, acc",
                          "const uint32_t (&a)[4], uint64_t b, int acc"))
    parts.append(dispatch("rs_tf32", RS_TF32, "", "", "a, b, acc",
                          "const uint32_t (&a)[4], uint64_t b, int acc"))
    parts.append("}  // namespace wgmma\n")
    return "\n".join(parts)


def main():
    OUT.write_text(render())
    print(OUT)


if __name__ == "__main__":
    main()
