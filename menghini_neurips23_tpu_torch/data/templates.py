"""Per-dataset textual prompt templates (reference data/dataset_prompts.py:1-7).

All datasets currently use the generic template; the dataset-specific variants
the reference keeps commented out are preserved here for completeness.
"""

DATASET_CUSTOM_PROMPTS = {
    "EuroSAT": "a photo of a {}",  # alt: 'a centered satellite photo of a {}'
    "DTD": "a photo of a {}",  # alt: 'a photo of a {} texture'
    "RESICS45": "a photo of a {}",  # alt: 'satellite imagery of a {}'
    "FGVCAircraft": "a photo of a {}",  # alt: 'a photo of a {}, a type of aircraft'
    "MNIST": "a photo of a {}",  # alt: 'a photo of the number: "{}"'
    "Flowers102": "a photo of a {}",  # alt: 'a photo of a {}, a type of flower'
    "CUB": "a photo of a {}",
}


def format_prompt(template: str, classname: str) -> str:
    """Fill a template with a class name, underscores -> spaces.

    The reference formats prompts as f"{template}{name}" in some call sites
    (utils/clip_pseudolabels.py:24) and template.format(name) in others
    (visual_prompt.py:63); since every template ends in '{}' both reduce to
    .format().
    """
    name = " ".join(classname.split("_"))
    if "{}" in template:
        return template.format(name)
    return f"{template}{name}"
