from menghini_neurips23_tpu_torch.data.datasets import (  # noqa: F401
    CUB,
    DATASET_CLASSES,
    DTD,
    EuroSAT,
    FGVCAircraft,
    FileListDataset,
    Flowers102,
    MNIST,
    RESICS45,
    dataset_object,
)
from menghini_neurips23_tpu_torch.data.loader import (  # noqa: F401
    Batch,
    ImageLoader,
    iter_image_batches,
    num_batches,
)
from menghini_neurips23_tpu_torch.data.prepare import (  # noqa: F401
    FRAMED,
    get_class_names,
    get_labeled_and_unlabeled_data,
    sample_few_shots,
    split_data,
    train_val_split,
)
from menghini_neurips23_tpu_torch.data.templates import (  # noqa: F401
    DATASET_CUSTOM_PROMPTS,
    format_prompt,
)
from menghini_neurips23_tpu_torch.data.transforms import (  # noqa: F401
    CLIP_MEAN,
    CLIP_STD,
    load_image,
    preprocess_pil,
)
