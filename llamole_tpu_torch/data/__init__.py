from .tokenizer import ByteTokenizer, load_tokenizer
from .template import get_template, Template
from .aligner import convert_molqa_record, align_dataset
from .processor import encode_supervised_example, preprocess_examples
from .collator import SeqGraphCollator
from .loader import get_dataset
