"""Weights of a Whisper configuration drawn on the device from the seed,
and the same weights placed into the program's model.

The benchmark draws the weights itself, in a plain layout of its own named
after openai/whisper's modules, so that the program and the plain
reference get the same numbers and the reference takes nothing that the
program made. Two calls of the device's generator make all of them: one
bf16 buffer for every matrix, embedding and convolution (the type they are
served in), one float32 buffer for the layer norms and biases. A second
`draw` with the same seed gives the same numbers.

Scales: matrices N(0, 1 / fan_in), the convolutions N(0, 0.05²), token and
decoder position embeddings N(0, 0.02²), biases N(0, 0.02²), layer-norm
gains 1 + N(0, 0.02²); the encoder's position table is Whisper's sinusoids
rounded to bf16. The convolutions, the query, value and output
projections and the MLP have biases; the key projections (self and cross)
have none, as in Whisper.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.whisper import Shape, sinusoids

MATRIX, VECTOR = "matrix", "vector"


def leaves(s: Shape) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, buffer, scale) of every weight, in drawing order.
    Vectors with scale None are layer-norm gains (1 + 0.02 N)."""
    d, f = s.d, 4 * s.d
    out = [("enc.conv1.w", (d, s.n_mels, 3), MATRIX, 0.05), ("enc.conv1.b", (d,), VECTOR, 0.02),
           ("enc.conv2.w", (d, d, 3), MATRIX, 0.05), ("enc.conv2.b", (d,), VECTOR, 0.02)]

    def ln(name):
        return [(name + ".g", (d,), VECTOR, None), (name + ".b", (d,), VECTOR, 0.02)]

    def lin(name, d_out, d_in, bias=True):
        return ([(name + ".w", (d_out, d_in), MATRIX, 1 / math.sqrt(d_in))]
                + ([(name + ".b", (d_out,), VECTOR, 0.02)] if bias else []))

    for i in range(s.enc_layers):
        p = f"enc.{i}."
        out += (ln(p + "attn_ln") + lin(p + "q", d, d) + lin(p + "k", d, d, bias=False)
                + lin(p + "v", d, d) + lin(p + "o", d, d) + ln(p + "mlp_ln")
                + lin(p + "fc1", f, d) + lin(p + "fc2", d, f))
    out += ln("enc.ln_post")
    out += [("dec.tok_emb", (s.n_vocab, d), MATRIX, 0.02),
            ("dec.pos", (s.text_ctx, d), MATRIX, 0.02)]
    for i in range(s.dec_layers):
        p = f"dec.{i}."
        out += (ln(p + "attn_ln") + lin(p + "q", d, d) + lin(p + "k", d, d, bias=False)
                + lin(p + "v", d, d) + lin(p + "o", d, d) + ln(p + "cross_ln")
                + lin(p + "cq", d, d) + lin(p + "ck", d, d, bias=False) + lin(p + "cv", d, d)
                + lin(p + "co", d, d) + ln(p + "mlp_ln") + lin(p + "fc1", f, d)
                + lin(p + "fc2", d, f))
    out += ln("dec.ln")
    return out


@torch.no_grad()
def draw(s: Shape, seed: int, device) -> dict[str, torch.Tensor]:
    """name -> tensor on `device`: bf16 matrices, float32 vectors."""
    items = leaves(s)
    sizes = {kind: sum(math.prod(shape) for _, shape, k, _ in items if k == kind)
             for kind in (MATRIX, VECTOR)}
    g = torch.Generator(device=device).manual_seed(seed & (2 ** 63 - 1))
    bufs = {MATRIX: torch.randn(sizes[MATRIX], generator=g, device=device,
                                dtype=torch.bfloat16),
            VECTOR: torch.randn(sizes[VECTOR], generator=g, device=device,
                                dtype=torch.float32)}
    out, offset = {}, {MATRIX: 0, VECTOR: 0}
    for name, shape, kind, scale in items:
        n = math.prod(shape)
        view = bufs[kind][offset[kind]:offset[kind] + n].view(shape)
        offset[kind] += n
        if scale is None:
            view.mul_(0.02).add_(1.0)
        else:
            view.mul_(scale)
        out[name] = view
    out["enc.pos"] = sinusoids(s.audio_ctx, s.d).to(device=device, dtype=torch.bfloat16)
    return out


@torch.no_grad()
def into_program(model, w: dict[str, torch.Tensor], s: Shape) -> None:
    """Copy the drawn weights into the program's model (its
    `models.whisper.Whisper` container): q, k and v side by side in one
    fused projection whose key bias is zero, every other leaf as it is."""
    enc, dec = model.encoder, model.decoder

    def lin(dst, name, bias=True):
        dst.weight.copy_(w[name + ".w"])
        if bias:
            dst.bias.copy_(w[name + ".b"])

    def ln(dst, name):
        dst.weight.copy_(w[name + ".g"])
        dst.bias.copy_(w[name + ".b"])

    def qkv(dst, p):
        dst.weight.copy_(torch.cat([w[p + "q.w"], w[p + "k.w"], w[p + "v.w"]]))
        dst.bias.copy_(torch.cat([w[p + "q.b"], torch.zeros_like(w[p + "q.b"]),
                                  w[p + "v.b"]]))

    for conv, name in ((enc.conv1, "enc.conv1"), (enc.conv2, "enc.conv2")):
        lin(conv, name)
    enc.pos.copy_(w["enc.pos"])
    for i, blk in enumerate(enc.blocks):
        p = f"enc.{i}."
        ln(blk.attn_ln, p + "attn_ln")
        qkv(blk.qkv, p)
        lin(blk.o, p + "o")
        ln(blk.mlp_ln, p + "mlp_ln")
        lin(blk.fc1, p + "fc1")
        lin(blk.fc2, p + "fc2")
    ln(enc.ln_post, "enc.ln_post")
    dec.tok_emb.copy_(w["dec.tok_emb"])
    dec.pos.copy_(w["dec.pos"])
    for i, blk in enumerate(dec.blocks):
        p = f"dec.{i}."
        ln(blk.attn_ln, p + "attn_ln")
        qkv(blk.qkv, p)
        lin(blk.o, p + "o")
        ln(blk.cross_ln, p + "cross_ln")
        lin(blk.cq, p + "cq")
        lin(blk.ck, p + "ck", bias=False)
        lin(blk.cv, p + "cv")
        lin(blk.co, p + "co")
        ln(blk.mlp_ln, p + "mlp_ln")
        lin(blk.fc1, p + "fc1")
        lin(blk.fc2, p + "fc2")
    ln(dec.ln, "dec.ln")
