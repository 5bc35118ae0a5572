"""YAML config handling.

Port of ``patchgan_tpu/utils/config.py``. Accepts both schemas of the
reference ecosystem:
- nested: ``model_params.generator.{filters, activation, use_dropout,
  final_activation}`` / ``model_params.discriminator.{filters, norm,
  n_layers}``;
- flat: ``model_params.{gen_filts, disc_filts, n_disc_layers,
  activation, use_dropout, final_activation}``;
and the data directories inside ``dataset:`` or at the top level.
"""

import warnings

import yaml


def load_config(path):
    with open(path, 'r') as infile:
        return yaml.safe_load(infile)


_NESTED_GEN_KEYS = {'filters', 'activation', 'use_dropout',
                    'final_activation'}
_NESTED_DISC_KEYS = {'filters', 'norm', 'n_layers'}
_FLAT_KEYS = {'gen_filts', 'disc_filts', 'n_disc_layers', 'activation',
              'use_dropout', 'final_activation', 'norm'}


def _warn_unknown(keys, known, where):
    unknown = sorted(set(keys) - known)
    if unknown:
        # a typo'd or mis-schema'd key would otherwise silently fall back
        # to the defaults
        warnings.warn(
            f"ignoring unrecognised {where} key(s) {unknown}; "
            f"recognised keys are {sorted(known)}", stacklevel=3)


def model_params(config):
    """Normalise model_params into (generator_cfg, discriminator_cfg)."""
    mp = config.get('model_params', {})
    if 'generator' in mp or 'discriminator' in mp:
        gcfg = dict(mp.get('generator', {}))
        dcfg = dict(mp.get('discriminator', {}))
        _warn_unknown(mp, {'generator', 'discriminator'}, 'model_params')
        _warn_unknown(gcfg, _NESTED_GEN_KEYS, 'model_params.generator')
        _warn_unknown(dcfg, _NESTED_DISC_KEYS,
                      'model_params.discriminator')
        gen = {
            'filters': gcfg.get('filters', 64),
            'activation': gcfg.get('activation', 'tanh'),
            'use_dropout': gcfg.get('use_dropout', True),
            'final_activation': gcfg.get('final_activation', 'sigmoid'),
        }
        disc = {
            'filters': dcfg.get('filters', 64),
            'norm': dcfg.get('norm', False),
            'n_layers': dcfg.get('n_layers', 3),
        }
    else:
        _warn_unknown(mp, _FLAT_KEYS, 'model_params')
        gen = {
            'filters': mp.get('gen_filts', 64),
            'activation': mp.get('activation', 'tanh'),
            'use_dropout': mp.get('use_dropout', True),
            'final_activation': mp.get('final_activation', 'sigmoid'),
        }
        disc = {
            'filters': mp.get('disc_filts', 64),
            'norm': mp.get('norm', False),
            'n_layers': mp.get('n_disc_layers', 3),
        }
    return gen, disc


def dataset_paths(config):
    """(train, validation, data, split): the train/validation directory
    mappings, or one data directory and a train/val split, looked up
    inside ``dataset:`` first and at the top level second
    (``patchgan_tpu/utils/config.py:82-101``)."""
    ds = config.get('dataset', {})

    def pick(key):
        return ds.get(key, config.get(key))

    train_data = pick('train_data')
    val_data = pick('validation_data')
    if train_data is not None and val_data is not None:
        return train_data, val_data, None, None
    data = pick('data')
    split = ds.get('train_val_split', config.get('train_val_split'))
    if data is not None and split is not None:
        return None, None, data, split
    raise AttributeError(
        "Please provide either the training and validation data paths "
        "or a train/val split!")
