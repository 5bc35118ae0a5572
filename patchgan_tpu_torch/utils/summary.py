"""Model summary printout: per-parameter shapes and counts.

Port of ``patchgan_tpu/utils/summary.py::summarize`` over
``named_parameters``.
"""


def count_params(module):
    return sum(p.numel() for p in module.parameters())


def summarize(name, module, input_shape=None):
    lines = [f"{'=' * 60}", f"{name}"]
    if input_shape is not None:
        lines.append(f"input: {tuple(input_shape)}")
    lines.append('-' * 60)
    for key, p in module.named_parameters():
        lines.append(f"  {key:<40} {str(tuple(p.shape)):<20} "
                     f"{p.numel():>10,}")
    lines.append('-' * 60)
    lines.append(f"  total parameters: {count_params(module):,}")
    lines.append('=' * 60)
    text = '\n'.join(lines)
    print(text)
    return text
