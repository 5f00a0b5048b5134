"""The parameter trees of LiDiff's networks: every weight and BatchNorm
statistic by name and shape, in the order of the published modules. The
benchmark makes weights of these shapes from its seed and hands the same
tensors to the program and to `nets`."""

from __future__ import annotations

from benchmark.reference.nets import channels

_BN = ("scale", "bias", "mean", "var")


def _bn(out: dict, name: str, c: int) -> None:
    for k in _BN:
        out[f"{name}.{k}"] = (c,)


def _conv_bn(out, name, cin, cout, taps=27, conv="SparseConv_0"):
    out[f"{name}.{conv}.kernel"] = (taps, cin, cout)
    _bn(out, f"{name}.MaskedBatchNorm_0", cout)


def _residual(out, name, cin, cout):
    out[f"{name}.SparseConv_0.kernel"] = (27, cin, cout)
    _bn(out, f"{name}.MaskedBatchNorm_0", cout)
    out[f"{name}.SparseConv_1.kernel"] = (27, cout, cout)
    _bn(out, f"{name}.MaskedBatchNorm_1", cout)
    if cin != cout:
        out[f"{name}.Dense_0.weight"] = (cout, cin)
        _bn(out, f"{name}.MaskedBatchNorm_2", cout)


def _mlp(out, name, cin, hidden, cout):
    out[f"{name}.Dense_0.weight"] = (hidden, cin)
    out[f"{name}.Dense_0.bias"] = (hidden,)
    out[f"{name}.Dense_1.weight"] = (cout, hidden)
    out[f"{name}.Dense_1.bias"] = (cout,)


def _stem(out, name, cs):
    _conv_bn(out, f"{name}.ConvBNReLU_0", 3, cs[0])
    _conv_bn(out, f"{name}.ConvBNReLU_1", cs[0], cs[0])


def _down(out, name, cin, mid, cout):
    _conv_bn(out, f"{name}.ConvBNReLU_0", cin, mid, taps=8)
    _residual(out, f"{name}.ResidualBlock_0", mid, cout)
    _residual(out, f"{name}.ResidualBlock_1", cout, cout)


def _up(out, name, cin, skip, up):
    _conv_bn(out, f"{name}.DeconvBNReLU_0", cin, up, taps=8,
             conv="SparseConvTranspose_0")
    _residual(out, f"{name}.ResidualBlock_0", up + skip, up)
    _residual(out, f"{name}.ResidualBlock_1", up, up)


def _downs(out, p, cs):
    for i in range(4):
        _down(out, f"{p}DownStage_{i}", cs[i], cs[i], cs[i + 1])


def _ups(out, p, cs):
    for i in range(4):
        _up(out, f"{p}UpStage_{i}", cs[4 + i], cs[3 - i], cs[5 + i])


def _gate(out, name, gate_out, hidden, c4, temb):
    _mlp(out, f"{name}.latent", c4, c4, c4)
    _mlp(out, f"{name}.temp", temb, temb, c4)
    _mlp(out, f"{name}.latemp", 2 * c4, hidden, gate_out)


def diffusion_shapes(out_dim: int = 96, cr: float = 1.0) -> dict:
    """`partial_enc.*` (MinkGlobalEnc) and `denoiser.*` (MinkUNetDiff)."""
    cs = channels(cr)
    out: dict = {}
    _stem(out, "partial_enc.Stem_0", cs)
    _downs(out, "partial_enc.", cs)
    p = "denoiser."
    _stem(out, p + "Stem_0", cs)
    gates = {"gate_s1": (cs[0], cs[4]), "gate_s2": (cs[1], cs[4]),
             "gate_s3": (cs[2], cs[4]), "gate_s4": (cs[3], cs[4]),
             "gate_u1": (cs[4], cs[4]), "gate_u2": (cs[5], cs[5]),
             "gate_u3": (cs[6], cs[6]), "gate_u4": (cs[7], cs[7])}
    for i in range(4):
        g = f"gate_s{i + 1}"
        _gate(out, p + g, *gates[g], cs[4], out_dim)
        _down(out, f"{p}DownStage_{i}", cs[i], cs[i], cs[i + 1])
    for i in range(4):
        g = f"gate_u{i + 1}"
        _gate(out, p + g, *gates[g], cs[4], out_dim)
        _up(out, f"{p}UpStage_{i}", cs[4 + i], cs[3 - i], cs[5 + i])
    _mlp(out, p + "head", cs[8], 20, 3)
    return out


def refiner_shapes(out_channels: int = 18, cr: float = 1.0) -> dict:
    cs = channels(cr)
    out: dict = {}
    _stem(out, "Stem_0", cs)
    _downs(out, "", cs)
    _ups(out, "", cs)
    _mlp(out, "head", cs[8], 20, out_channels)
    return out
